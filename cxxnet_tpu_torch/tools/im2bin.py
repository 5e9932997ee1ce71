#!/usr/bin/env python3
"""im2bin: pack images listed in a .lst into a BinaryPage .bin file (own
copy of cxxnet_tpu/tools/im2bin.py; both write the same bytes).

Tool parity with tools/im2bin.cpp:6-67: reads `index \\t label \\t filename`
lines and appends each image file's raw bytes as one blob.

Usage: python -m cxxnet_tpu_torch.tools.im2bin <image.lst> <image_root>
       <output.bin>
"""

import sys

from cxxnet_tpu_torch.io.iter_img import parse_list_file
from cxxnet_tpu_torch.utils.binary_page import BinaryPageWriter


def im2bin(list_path: str, image_root: str, out_path: str) -> int:
    entries = parse_list_file(list_path)
    count = 0
    with open(out_path, "wb") as fo:
        writer = BinaryPageWriter(fo)
        for _, _, fname in entries:
            with open(image_root + fname, "rb") as f:
                writer.push(f.read())
            count += 1
            if count % 1000 == 0:
                print(f"{count} images packed")
        writer.close()
    print(f"im2bin: packed {count} images into {out_path}")
    return count


def cli_main() -> None:
    if len(sys.argv) != 4:
        print(__doc__)
        sys.exit(1)
    im2bin(sys.argv[1], sys.argv[2], sys.argv[3])


if __name__ == "__main__":
    cli_main()
