#!/usr/bin/env python3
"""imgbin_partition: shard a big .lst into N .lst/.bin partitions (own
copy of cxxnet_tpu/tools/imgbin_partition.py; both write the same bytes,
the Makefile naming this package's im2bin).

Tool parity with tools/imgbin-partition-maker.py (which emits a Makefile
whose targets im2bin each shard so `make -j` packs them in parallel).
Partitioned bins feed the imgbinx iterator's multi-bin mode
(`image_conf_prefix`/`image_conf_ids`) and per-worker sharding in
distributed runs (iter_thread_imbin-inl.hpp:189-220).

Usage:
  python -m cxxnet_tpu_torch.tools.imgbin_partition <image.lst>
      <image_root> <out_prefix> <nparts>
      [--mode=contiguous|roundrobin] [--pack | --makefile]

Writes <out_prefix>.<i>.lst for i in [0, nparts); with --pack also packs
each shard into <out_prefix>.<i>.bin in-process, with --makefile emits
<out_prefix>.mk whose targets call im2bin per shard (the reference's
parallel-make workflow).
"""

from __future__ import annotations

import sys
from typing import List, Tuple

from cxxnet_tpu_torch.io.iter_img import parse_list_file


def partition_list(entries: List[Tuple[int, List[float], str]],
                   nparts: int, mode: str = "contiguous",
                   ) -> List[List[Tuple[int, List[float], str]]]:
    if nparts <= 0:
        raise ValueError("nparts must be positive")
    if mode == "contiguous":
        # same arithmetic as the distributed reader shard split:
        # part i gets [i*ceil(n/k), min((i+1)*ceil(n/k), n))
        step = (len(entries) + nparts - 1) // nparts
        return [entries[i * step: (i + 1) * step] for i in range(nparts)]
    if mode == "roundrobin":
        return [entries[i::nparts] for i in range(nparts)]
    raise ValueError(f"unknown partition mode {mode}")


def _write_lst(path: str,
               entries: List[Tuple[int, List[float], str]]) -> None:
    with open(path, "w", encoding="utf-8") as f:
        for idx, labels, fname in entries:
            lab = "\t".join(repr(v) for v in labels)  # exact round-trip
            f.write(f"{idx}\t{lab}\t{fname}\n")


def make_partitions(list_path: str, image_root: str, out_prefix: str,
                    nparts: int, mode: str = "contiguous",
                    pack: bool = False, makefile: bool = False,
                    ) -> List[str]:
    entries = parse_list_file(list_path)
    parts = partition_list(entries, nparts, mode)
    lst_paths = []
    for i, part in enumerate(parts):
        lst = f"{out_prefix}.{i}.lst"
        _write_lst(lst, part)
        lst_paths.append(lst)
    if pack:
        from cxxnet_tpu_torch.tools.im2bin import im2bin
        for i, lst in enumerate(lst_paths):
            im2bin(lst, image_root, f"{out_prefix}.{i}.bin")
    if makefile:
        mk = f"{out_prefix}.mk"
        with open(mk, "w", encoding="utf-8") as f:
            bins = " ".join(f"{out_prefix}.{i}.bin"
                            for i in range(nparts))
            f.write(f"all: {bins}\n\n")
            for i in range(nparts):
                f.write(f"{out_prefix}.{i}.bin: {out_prefix}.{i}.lst\n")
                f.write(f"\tpython -m cxxnet_tpu_torch.tools.im2bin "
                        f"{out_prefix}.{i}.lst {image_root} $@\n\n")
            f.write(".PHONY: all\n")
    return lst_paths


def cli_main() -> None:
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    opts = [a for a in sys.argv[1:] if a.startswith("--")]
    if len(args) != 4:
        print(__doc__)
        sys.exit(1)
    mode = "contiguous"
    pack = makefile = False
    for o in opts:
        if o.startswith("--mode="):
            mode = o.split("=", 1)[1]
        elif o == "--pack":
            pack = True
        elif o == "--makefile":
            makefile = True
        else:
            print(f"unknown option {o}")
            sys.exit(1)
    make_partitions(args[0], args[1], args[2], int(args[3]), mode,
                    pack, makefile)


if __name__ == "__main__":
    cli_main()
