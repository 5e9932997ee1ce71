"""Evaluation metrics on the device (own copy of cxxnet_tpu/utils/metric.py
and utils/metric_jit.py; src/utils/metric.h:20-236).

Each metric maps (pred2d, label, mask, gen) to a (sum, count) pair of
float32 scalars on pred's device, over the rows with mask > 0:

- ``error``:   argmax(pred) != label[0]; a single-column prediction
  decides by ``pred > 0`` (metric.h:91-110).
- ``rmse``:    per-row SUM of squared differences, averaged over rows -
  the reference never takes the square root (metric.h:72-88).
- ``logloss``: -log(p[target]), each log argument clipped to
  [1e-15, 1] (in float32 1-1e-15 rounds to 1, so a saturated p = 1
  gives log(eps) for the other side, not -inf); binary form for a
  single column (metric.h:113-132).
- ``rec@n``:   fraction of the row's labels found in the top-n
  predictions; ties broken at random, like the reference's shuffle
  before its stable sort, with draws from the explicit `gen` (on a
  data mesh this rank's rows of the global batch's draw,
  layers/base.py rank_rand).

The trainer adds the pairs up on the device and reads them back once
per round (train metrics) or once per dataset (evaluate), and
`format_metrics` renders ``\\t{evname}-{metric}[{field}]:{value}``
byte for byte like the JAX package (the field suffix is omitted for the
default "label" field).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

from cxxnet_tpu_torch.layers.base import rank_rand

StepFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor,
                   Optional[torch.Generator]],
                  Tuple[torch.Tensor, torch.Tensor]]


def _masked(vals: torch.Tensor, mask: torch.Tensor):
    m = mask > 0
    return (torch.where(m, vals.float(), torch.zeros_like(vals.float()))
            .sum(), m.float().sum())


def _error(pred, label, mask, gen):
    if pred.shape[1] == 1:
        maxidx = (pred[:, 0] > 0.0).long()
    else:
        maxidx = torch.argmax(pred, dim=1)
    return _masked((maxidx != label[:, 0].long()).float(), mask)


def _rmse(pred, label, mask, gen):
    if pred.shape != label.shape:
        raise ValueError(
            "rmse metric requires pred and label of identical shape")
    diff = pred - label
    return _masked(torch.sum(diff * diff, dim=1), mask)


def _logloss(pred, label, mask, gen):
    eps = 1e-15
    if pred.shape[1] == 1:
        p = pred[:, 0]
        y = label[:, 0]
        vals = -(y * torch.log(p.clamp(eps, 1.0))
                 + (1.0 - y) * torch.log((1.0 - p).clamp(eps, 1.0)))
    else:
        p = torch.gather(pred, 1, label[:, :1].long())[:, 0]
        vals = -torch.log(p.clamp(eps, 1.0))
    return _masked(vals, mask)


def _make_recall(topn: int) -> StepFn:
    def rec(pred, label, mask, gen):
        n, k = pred.shape
        if k < topn:
            raise ValueError(
                f"rec@{topn} meaningless for prediction list of size {k}")
        # order by -pred, exact ties by a random key: sort by the key,
        # then stably by -pred
        jitter = rank_rand(pred.shape, gen, device=pred.device)
        by_key = torch.argsort(jitter, dim=1)
        by_pred = torch.argsort(torch.gather(-pred, 1, by_key), dim=1,
                                stable=True)
        top = torch.gather(by_key, 1, by_pred)[:, :topn]
        labels = label.long()
        hits = (top[:, :, None] == labels[:, None, :]).any(dim=1)
        return _masked(hits.sum(dim=1).float() / labels.shape[1], mask)
    return rec


def create_step_fn(name: str) -> StepFn:
    """The metric named in a conf (`error`, `rmse`, `logloss`,
    `rec@n`); anything else raises."""
    if name == "error":
        return _error
    if name == "rmse":
        return _rmse
    if name == "logloss":
        return _logloss
    if name.startswith("rec@"):
        return _make_recall(int(name[4:]))
    raise ValueError(f"Metric: unknown metric name: {name}")


class MetricSet:
    """The conf's metrics in declaration order: (metric name, label
    field) specs and their step functions."""

    def __init__(self) -> None:
        self.specs: List[Tuple[str, str]] = []
        self.fns: List[StepFn] = []

    def add_metric(self, name: str, field: str = "label") -> None:
        self.fns.append(create_step_fn(name))
        self.specs.append((name, field))

    def __len__(self) -> int:
        return len(self.specs)


def format_metrics(evname: str, specs: Sequence[Tuple[str, str]],
                   sums_counts) -> str:
    """Render accumulated (sum, count) rows in the reference format
    `\\t{evname}-{metric}[{field}]:{value}` (metric.h:216-235)."""
    out = []
    for (name, field), (s, c) in zip(specs, sums_counts):
        val = s / c if c else float("nan")
        tag = f"{evname}-{name}"
        if field != "label":
            tag += f"[{field}]"
        out.append(f"\t{tag}:{val:g}")
    return "".join(out)
