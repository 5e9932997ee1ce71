"""TVM-style persistent per-platform tuning cache (arXiv:1802.04799);
own copy of cxxnet_tpu/nnet/tuning.py - the same file format, so a
cache written by either package loads in the other.

`tools/autotune.py` searches the dispatch/staging/serving knob space
against measured throughput and persists the winners here; the CLI
and wrapper pick them up via `tuning_cache = <path>` (docs/
GRAPH_PASSES.md "Autotuner"). Contract: tuned values are DEFAULTS -
a key the user's config sets explicitly always wins, and a cache
entry for a different platform (or an inapplicable knob) is silently
ignored, so shipping one cache file across a heterogeneous fleet is
safe.

Schema v2 steps the cache up from global knobs to PER-LAYER plans
(the Relay/TVM per-operator decision, arXiv:1810.00952): each
platform entry may carry a `layers` map of per-layer knob choices
(`space_to_depth` per conv, `layer_dtype` feeding the autocast
pass's dtype plan, `layer_quant` pinning the quantize_int8 pass's
per-layer int8-vs-float kernel route) and a `serve_ladder` - explicit
serving bucket
sizes shaped from the observed request-size histogram instead of the
fixed power-of-two set (serve/server.py `ladder_from_histogram`).
v1 caches (global knobs only) load through a one-shot in-memory
migration; anything structurally invalid still raises ConfigError.

File format (JSON, written atomically):

    {"version": 2,
     "platforms": {
       "cpu": {"knobs": {"steps_per_dispatch": 4, "prefetch_stage": 1,
                         "serve_max_batch": 32, "stage_dtype": ""},
               "layers": {"c1": {"space_to_depth": "1"},
                          "fc6": {"layer_dtype": "float32"}},
               "serve_ladder": [2, 6, 16, 32],
               "measured": {"default_ips": ..., "best_ips": ...},
               "device_kind": "...", "date": "YYYY-MM-DD"}}}
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

from cxxnet_tpu_torch.utils.config import ConfigError

VERSION = 2

#: every GLOBAL knob the autotuner may set, with the config key it
#: maps to. `stage_dtype` is the staged-input layout axis (f32 vs
#: bf16 H2D bytes - docs/PERFORMANCE.md); `serve_max_batch` is the
#: serving bucket-ladder ceiling (docs/SERVING.md).
TUNABLE_KEYS = ("steps_per_dispatch", "prefetch_stage",
                "serve_max_batch", "stage_dtype")

#: every PER-LAYER knob a v2 plan may carry (values are layer-config
#: stamps applied by the trainer under explicit-keys-win).
#: `layer_quant` (int8|float, the quantize_int8 pass's per-layer
#: kernel-route pin - docs/GRAPH_PASSES.md "Quantization") is a
#: compatible v2 extension: caches without it load unchanged, and a
#: cache carrying it is rejected by builds that predate the knob via
#: the unknown-per-layer-knob check below (regenerate with that
#: build's tools/autotune.py), never silently misapplied
LAYER_TUNABLE_KEYS = ("space_to_depth", "layer_dtype", "layer_quant")


def _check_ladder(path: str, plat: str, ladder) -> None:
    if (not isinstance(ladder, list) or not ladder
            or not all(isinstance(b, int) and not isinstance(b, bool)
                       and b >= 1 for b in ladder)
            or sorted(set(ladder)) != ladder):
        raise ConfigError(
            f"tuning_cache: {path} platform '{plat}' 'serve_ladder' "
            f"must be a strictly increasing list of positive ints, "
            f"got {ladder!r}")


def load_cache(path: str) -> dict:
    """Parse + schema-check a tuning-cache file (raises ConfigError:
    a cache the user POINTED AT must never be silently garbage).
    v1 caches migrate to the v2 shape in memory - one-shot, no write
    on read; save_entry persists v2."""
    try:
        with open(path, "r", encoding="utf-8") as f:
            blob = json.load(f)
    except OSError as e:
        raise ConfigError(f"tuning_cache: cannot read {path}: {e}")
    except ValueError as e:
        raise ConfigError(f"tuning_cache: {path} is not JSON: {e}")
    if (not isinstance(blob, dict)
            or not isinstance(blob.get("platforms"), dict)):
        raise ConfigError(
            f"tuning_cache: {path} has no 'platforms' mapping (not a "
            "tools/autotune.py artifact?)")
    version = blob.get("version", 1)
    if not isinstance(version, int) or version not in (1, VERSION):
        raise ConfigError(
            f"tuning_cache: {path} carries schema version {version!r}"
            f"; this build reads versions 1-{VERSION} (re-run "
            "tools/autotune.py to regenerate)")
    for plat, entry in blob["platforms"].items():
        if entry is not None and not isinstance(entry, dict):
            raise ConfigError(
                f"tuning_cache: {path} platform '{plat}' entry is "
                f"{type(entry).__name__}, expected an object")
        knobs = (entry or {}).get("knobs", {})
        if not isinstance(knobs, dict):
            raise ConfigError(
                f"tuning_cache: {path} platform '{plat}' 'knobs' is "
                f"{type(knobs).__name__}, expected an object")
        unknown = [k for k in knobs if k not in TUNABLE_KEYS]
        if unknown:
            raise ConfigError(
                f"tuning_cache: {path} platform '{plat}' carries "
                f"unknown knob(s) {unknown}; tunable keys are "
                f"{list(TUNABLE_KEYS)}")
        layers = (entry or {}).get("layers", {})
        if layers is None:
            layers = {}
        if not isinstance(layers, dict):
            raise ConfigError(
                f"tuning_cache: {path} platform '{plat}' 'layers' is "
                f"{type(layers).__name__}, expected an object")
        for lname, kv in layers.items():
            if not isinstance(kv, dict):
                raise ConfigError(
                    f"tuning_cache: {path} platform '{plat}' layer "
                    f"'{lname}' plan is {type(kv).__name__}, expected "
                    "an object")
            bad = [k for k in kv if k not in LAYER_TUNABLE_KEYS]
            if bad:
                raise ConfigError(
                    f"tuning_cache: {path} platform '{plat}' layer "
                    f"'{lname}' carries unknown per-layer knob(s) "
                    f"{bad}; tunable keys are {list(LAYER_TUNABLE_KEYS)}")
        ladder = (entry or {}).get("serve_ladder")
        if ladder is not None:
            _check_ladder(path, plat, ladder)
    if version == 1:
        # one-shot migration: a global-only v1 cache becomes a v2
        # blob with empty per-layer plans - the structure every
        # consumer below reads
        blob["version"] = VERSION
        for entry in blob["platforms"].values():
            if isinstance(entry, dict):
                entry.setdefault("layers", {})
    return blob


def platform_name(device) -> str:
    """The cache's platform key for a torch device: "cpu" on the CPU,
    "gpu" on the card - what jax.default_backend() names the same
    hardware, so one cache file serves both packages."""
    return "cpu" if str(device).startswith("cpu") else "gpu"


def platform_entry(path: str,
                   platform: Optional[str] = None) -> dict:
    """The (validated, migrated) cache entry for `platform` (default:
    the card's, "gpu"); {} when the cache has no entry for it."""
    blob = load_cache(path)
    if platform is None:
        platform = platform_name("cuda")
    return blob["platforms"].get(platform) or {}


def tuned_knobs(path: str,
                platform: Optional[str] = None) -> Dict[str, str]:
    """The cache's GLOBAL knob dict for `platform`, values
    stringified for set_param-style application. {} when the cache
    has no entry for this platform."""
    entry = platform_entry(path, platform)
    return {k: str(v) for k, v in entry.get("knobs", {}).items()}


def tuned_layer_plan(path: str, platform: Optional[str] = None
                     ) -> Dict[str, Dict[str, str]]:
    """The cache's per-layer plan for `platform`:
    {layer_name: {knob: value}}, values stringified. {} for v1 caches
    or platforms without an entry."""
    entry = platform_entry(path, platform)
    return {ln: {k: str(v) for k, v in kv.items()}
            for ln, kv in (entry.get("layers") or {}).items()}


def tuned_serve_ladder(path: str, platform: Optional[str] = None
                       ) -> Optional[List[int]]:
    """The cache's serving bucket ladder for `platform`, or None when
    absent (the Server then falls back to the power-of-two set)."""
    entry = platform_entry(path, platform)
    ladder = entry.get("serve_ladder")
    return list(ladder) if ladder else None


def int_knob(knobs: Dict[str, str], key: str, explicit,
             minimum: int) -> Optional[int]:
    """THE apply rule for integer tunables, shared by every consumer
    (main.LearnTask and NetTrainer) so they can never disagree on
    the same cache file: the knob must be present, not explicitly
    set by the config (`explicit` = the keys the config named),
    parseable as int, and >= minimum - anything else returns None
    (a malformed value in an otherwise-valid shared cache skips,
    never errors)."""
    if key not in knobs or key in explicit:
        return None
    try:
        v = int(knobs[key])
    except ValueError:
        return None
    return v if v >= minimum else None


def save_entry(path: str, platform: str, knobs: Dict[str, object],
               measured: Optional[Dict[str, float]] = None,
               device_kind: str = "",
               layers: Optional[Dict[str, Dict[str, object]]] = None,
               serve_ladder: Optional[List[int]] = None) -> dict:
    """Merge one platform's tuned knobs (plus the optional v2
    per-layer plan and serve ladder) into the cache file (atomic
    write via tmp + replace; other platforms' entries are
    preserved)."""
    unknown = [k for k in knobs if k not in TUNABLE_KEYS]
    if unknown:
        raise ValueError(f"untunable knob(s) {unknown}")
    for lname, kv in (layers or {}).items():
        bad = [k for k in kv if k not in LAYER_TUNABLE_KEYS]
        if bad:
            raise ValueError(
                f"untunable per-layer knob(s) {bad} for layer "
                f"'{lname}'")
    if serve_ladder is not None:
        serve_ladder = sorted({int(b) for b in serve_ladder})
        _check_ladder(path, platform, serve_ladder)
    if os.path.exists(path):
        # an EXISTING cache must parse before we merge into it: a
        # corrupt file (or one written by a newer version with knobs
        # this build doesn't know) raises instead of being silently
        # replaced - the atomic write below would otherwise destroy
        # every other platform's entries
        blob = load_cache(path)
    else:
        blob = {"version": VERSION, "platforms": {}}
    blob["version"] = VERSION
    entry = {
        "knobs": dict(knobs),
        "layers": {ln: {k: str(v) for k, v in kv.items()}
                   for ln, kv in (layers or {}).items()},
        "measured": dict(measured or {}),
        "device_kind": device_kind,
        "date": time.strftime("%Y-%m-%d"),
    }
    if serve_ladder is not None:
        entry["serve_ladder"] = serve_ladder
    blob["platforms"][platform] = entry
    from cxxnet_tpu_torch.utils.fault import atomic_writer
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with atomic_writer(path, "w") as f:
        json.dump(blob, f, indent=1, sort_keys=True)
        f.write("\n")
    return blob
