"""NetConfig: `key = value` config stream -> layer DAG (own copy of
cxxnet_tpu/nnet/net_config.py; it parses confs whose layers the port
cannot run yet - the Network build rejects those).

Behavioral parity with src/nnet/nnet_config.h:26-411:

- `netconfig = start/end` brackets the net block; `layer[...] = type[:name]`
  lines declare connections and switch subsequent params into that layer's
  private config; params outside any layer go into `defcfg` and are replayed
  into EVERY layer (global defaults like random_type).
- Layer syntax (nnet_config.h:303-360):
    layer[+1]          input = top node, fresh anonymous output node
    layer[+0]          self-loop (in == out), e.g. dropout/loss layers
    layer[+1:name]     fresh output node named `name`
    layer[a->b]        explicit nodes; `a`/`b` may be comma lists
    layer[a,b->c]      multi-input connection
  Node names may be arbitrary strings; node "0"/"in" is the data input.
  Input nodes must already exist; output nodes are allocated on first use.
- `share[tag]` layers reuse the params of the primary layer named `tag`
  (weight sharing; kSharedLayer).
- Global params captured here: `updater`, `sync`, `label_vec[a,b) = name`
  (label column slicing), `input_shape = c,h,w`, `extra_data_num`,
  `extra_data_shape[i] = c,h,w`.
- Structure equality is validated when configuring on top of a loaded net
  (model file vs config consistency - nnet_config.h:266-271).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

ConfigPairs = List[Tuple[str, str]]

_LAYER_KEY_RE = re.compile(r"^layer\[")


@dataclass
class LayerInfo:
    """One connection declaration (nnet_config.h LayerInfo)."""

    type_name: str = ""
    primary_layer_index: int = -1  # >= 0 for shared layers
    name: str = ""
    nindex_in: List[int] = field(default_factory=list)
    nindex_out: List[int] = field(default_factory=list)

    @property
    def is_shared(self) -> bool:
        return self.primary_layer_index >= 0

    def structure_equals(self, other: "LayerInfo") -> bool:
        return (self.type_name == other.type_name
                and self.primary_layer_index == other.primary_layer_index
                and self.name == other.name
                and self.nindex_in == other.nindex_in
                and self.nindex_out == other.nindex_out)


class NetConfig:
    """Parses and holds the network structure + per-layer configs."""

    def __init__(self) -> None:
        self.input_shape: Tuple[int, int, int] = (0, 0, 0)  # (c, y, x)
        self.extra_data_num = 0
        self.extra_shape: List[int] = []
        self.layers: List[LayerInfo] = []
        self.node_names: List[str] = []
        self.node_name_map: Dict[str, int] = {}
        self.layer_name_map: Dict[str, int] = {}
        self.updater_type = "sgd"
        self.sync_type = "simple"
        self.label_name_map: Dict[str, int] = {"label": 0}
        self.label_range: List[Tuple[int, int]] = [(0, 1)]
        self.defcfg: ConfigPairs = []
        self.layercfg: List[ConfigPairs] = []
        self.init_end = False

    @property
    def num_nodes(self) -> int:
        return len(self.node_names)

    @property
    def num_layers(self) -> int:
        return len(self.layers)

    # ------------------------------------------------------------------
    def set_global_param(self, name: str, val: str) -> None:
        if name == "updater":
            self.updater_type = val
        if name == "sync":
            self.sync_type = val
        m = re.match(r"^label_vec\[(\d+),(\d+)\)$", name)
        if m:
            self.label_range.append((int(m.group(1)), int(m.group(2))))
            self.label_name_map[val] = len(self.label_range) - 1

    # ------------------------------------------------------------------
    def configure(self, cfg: ConfigPairs) -> None:
        """Replay an ordered config into the structure (Configure)."""
        self._clear_config()
        if not self.node_names and not self.node_name_map:
            self.node_names.append("in")
            self.node_name_map["in"] = 0
        self.node_name_map["0"] = 0

        netcfg_mode = 0
        cfg_top_node = 0
        cfg_layer_index = 0
        for name, val in cfg:
            if name == "extra_data_num":
                num = int(val)
                for i in range(num):
                    nname = f"in_{i + 1}"
                    if nname not in self.node_name_map:
                        self.node_names.append(nname)
                        self.node_name_map[nname] = i + 1
                self.extra_data_num = num
            if name.startswith("extra_data_shape["):
                x, y, z = (int(t) for t in val.split(","))
                self.extra_shape.extend([x, y, z])
            if not self.init_end and name == "input_shape":
                c, y, x = (int(t) for t in val.split(","))
                self.input_shape = (c, y, x)
            if netcfg_mode != 2:
                self.set_global_param(name, val)
            if name == "netconfig" and val == "start":
                netcfg_mode = 1
            if name == "netconfig" and val == "end":
                netcfg_mode = 0
            if _LAYER_KEY_RE.match(name):
                info = self._get_layer_info(name, val, cfg_top_node,
                                            cfg_layer_index)
                netcfg_mode = 2
                if not self.init_end:
                    assert len(self.layers) == cfg_layer_index, \
                        "NetConfig inconsistent"
                    self.layers.append(info)
                    self.layercfg.append([])
                else:
                    if cfg_layer_index >= len(self.layers):
                        raise ValueError("config layer index exceeds bound")
                    if not info.structure_equals(self.layers[cfg_layer_index]):
                        raise ValueError(
                            "config setting does not match existing network "
                            "structure")
                cfg_top_node = (info.nindex_out[0]
                                if len(info.nindex_out) == 1 else -1)
                cfg_layer_index += 1
                continue
            if netcfg_mode == 2:
                if self.layers[cfg_layer_index - 1].is_shared:
                    raise ValueError(
                        "please do not set parameters in shared layer, "
                        "set them in primary layer")
                self.layercfg[cfg_layer_index - 1].append((name, val))
            else:
                self.defcfg.append((name, val))
        if not self.init_end:
            self._init_net()

    # ------------------------------------------------------------------
    def get_layer_index(self, name: str) -> int:
        if name not in self.layer_name_map:
            raise KeyError(f"unknown layer name {name}")
        return self.layer_name_map[name]

    def get_node_index(self, name: str, alloc_unknown: bool) -> int:
        if name in self.node_name_map:
            return self.node_name_map[name]
        if not alloc_unknown:
            raise ValueError(
                f"ConfigError: undefined node name {name}; the input node "
                "of a layer must be the output of an earlier layer")
        value = len(self.node_names)
        self.node_name_map[name] = value
        self.node_names.append(name)
        return value

    # ------------------------------------------------------------------
    def _get_layer_info(self, name: str, val: str, top_node: int,
                        cfg_layer_index: int) -> LayerInfo:
        info = LayerInfo()
        # --- node spec ---
        m = re.match(r"^layer\[\+(\d+)(?::([^\]]+))?\]$", name)
        if m:
            if top_node < 0:
                raise ValueError(
                    "ConfigError: layer[+1] used, but the last layer has "
                    "more than one output; use layer[in->out] instead")
            inc = int(m.group(1))
            info.nindex_in.append(top_node)
            if m.group(2):
                info.nindex_out.append(
                    self.get_node_index(m.group(2), True))
            elif inc == 0:
                info.nindex_out.append(top_node)
            else:
                # key anonymous nodes by the LAYER index, not the top
                # node: two `layer[+1]` declarations whose top is the
                # same node (after an explicit re-target) must allocate
                # distinct output nodes, as the reference's positional
                # allocation does
                tag = f"!node-of-layer-{cfg_layer_index}"
                info.nindex_out.append(self.get_node_index(tag, True))
        else:
            m = re.match(r"^layer\[([^\]>]+)->([^\]]+)\]$", name)
            if not m:
                raise ValueError(f"ConfigError: invalid layer format {name}")
            for tok in m.group(1).split(","):
                info.nindex_in.append(self.get_node_index(tok, False))
            for tok in m.group(2).split(","):
                info.nindex_out.append(self.get_node_index(tok, True))

        # --- type spec: `type`, `type:name`, `share[tag]` ---
        if ":" in val:
            ltype, layer_name = val.split(":", 1)
        else:
            ltype, layer_name = val, ""
        if ltype.startswith("share"):
            m = re.match(r"^share\[([^\]]+)\]$", ltype)
            if not m:
                raise ValueError(
                    "ConfigError: shared layer must specify the tag of the "
                    "layer to share with")
            tag = m.group(1)
            if tag not in self.layer_name_map:
                raise ValueError(
                    f"ConfigError: shared layer tag {tag} is not defined "
                    "before")
            info.type_name = "share"
            info.primary_layer_index = self.layer_name_map[tag]
        else:
            info.type_name = ltype
            if layer_name:
                if layer_name in self.layer_name_map:
                    if self.layer_name_map[layer_name] != cfg_layer_index:
                        raise ValueError(
                            "ConfigError: layer name in the configuration "
                            "file does not match the name stored in model")
                else:
                    self.layer_name_map[layer_name] = cfg_layer_index
                info.name = layer_name
        return info

    # ------------------------------------------------------------------
    def _init_net(self) -> None:
        num_nodes = 0
        for info in self.layers:
            for j in info.nindex_in + info.nindex_out:
                num_nodes = max(j + 1, num_nodes)
        assert num_nodes == len(self.node_names), \
            "num_nodes inconsistent with node_names"
        self.init_end = True

    def _clear_config(self) -> None:
        self.defcfg = []
        self.layercfg = [[] for _ in self.layercfg]

    # ------------------------------------------------------------------
    def clone(self) -> "NetConfig":
        """Deep structural copy INCLUDING the replayed per-layer
        configs and label maps (to_dict is structure-only, by the
        checkpoint contract) - what the graph-pass pipeline
        (nnet/passes.py) transforms, so the trainer's own NetConfig
        never mutates under an inference-only rewrite."""
        cfg = NetConfig()
        cfg.input_shape = tuple(self.input_shape)
        cfg.extra_data_num = self.extra_data_num
        cfg.extra_shape = list(self.extra_shape)
        cfg.node_names = list(self.node_names)
        cfg.node_name_map = dict(self.node_name_map)
        cfg.layer_name_map = dict(self.layer_name_map)
        cfg.updater_type = self.updater_type
        cfg.sync_type = self.sync_type
        cfg.label_name_map = dict(self.label_name_map)
        cfg.label_range = list(self.label_range)
        cfg.defcfg = list(self.defcfg)
        cfg.layercfg = [list(c) for c in self.layercfg]
        cfg.layers = [
            LayerInfo(type_name=li.type_name,
                      primary_layer_index=li.primary_layer_index,
                      name=li.name,
                      nindex_in=list(li.nindex_in),
                      nindex_out=list(li.nindex_out))
            for li in self.layers]
        cfg.init_end = self.init_end
        return cfg

    # ------------------------------------------------------------------
    # structure (de)serialization for checkpoints
    # ------------------------------------------------------------------
    def to_dict(self) -> dict:
        """Structure-only snapshot (SaveNet analog; training params like
        updater_type are NOT saved, matching nnet_config.h:126-145)."""
        return {
            "input_shape": list(self.input_shape),
            "extra_data_num": self.extra_data_num,
            "extra_shape": list(self.extra_shape),
            "node_names": list(self.node_names),
            "layers": [
                {
                    "type": li.type_name,
                    "primary_layer_index": li.primary_layer_index,
                    "name": li.name,
                    "nindex_in": list(li.nindex_in),
                    "nindex_out": list(li.nindex_out),
                }
                for li in self.layers
            ],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "NetConfig":
        cfg = cls()
        cfg.input_shape = tuple(d["input_shape"])
        cfg.extra_data_num = d["extra_data_num"]
        cfg.extra_shape = list(d["extra_shape"])
        cfg.node_names = list(d["node_names"])
        cfg.node_name_map = {n: i for i, n in enumerate(cfg.node_names)}
        for i, ld in enumerate(d["layers"]):
            li = LayerInfo(
                type_name=ld["type"],
                primary_layer_index=ld["primary_layer_index"],
                name=ld["name"],
                nindex_in=list(ld["nindex_in"]),
                nindex_out=list(ld["nindex_out"]),
            )
            cfg.layers.append(li)
            cfg.layercfg.append([])
            if li.name and not li.is_shared:
                if li.name in cfg.layer_name_map:
                    raise ValueError(
                        f"invalid model file, duplicated layer name: "
                        f"{li.name}")
                cfg.layer_name_map[li.name] = i
        cfg.init_end = True
        return cfg
