"""The CLI (counterpart of cxxnet_tpu/main.py):

    python -m cxxnet_tpu_torch.main <config.conf> [k=v ...]

- `task = train` (default) trains from the `data = ...` iterator block
  for rounds start_counter..num_round (at most max_round of them),
  printing `[N]\ttrain-metric:x\tevalname-metric:y` to stderr after
  each round and saving `model_dir/%04d.model` every `save_model`
  rounds; from scratch, or from `model_in = <checkpoint>`;
  `continue = 1` resumes from the newest checkpoint in model_dir (an
  empty model_dir is an error);
- `task = finetune` builds the net from the conf and copies the
  params of the layers whose names match from `model_in`;
- `task = pred` writes one prediction per line (argmax of the final
  node, or its raw value when it has one column);
- `task = pred_raw` writes the final node's full row per instance;
- `task = serve` replays the pred iterator as a ragged request stream
  through the continuous-batching Server; its output file matches
  `task = pred` line for line.

Iterator blocks (`data =`, `eval = <name>`, `pred = <file>`, each ended
by `iter = end`) build the io/ chains: mnist, img, imgbin / imgbinx with
the host augmenter, threadbuffer, membuffer, attachtxt. The train loop
stages each batch one ahead on a worker thread (`prefetch_stage = N`,
default 1: io/prefetch.py, pinned buffers and a side stream on the
card; 0 streams, staging inside the step). Under `device_augment = 1`
every block the task builds must carry the trainer's normalization
spec, or the CLI raises, as the JAX CLI does.

Graph passes (`graph_passes = a,b,...`, `pass_<name> = 0|1`) reach the
trainer from the conf and argv. fold_conv_bn / quantize_int8 calibrate
on the first batch the pred tasks run (task = serve: on the first pred
batch, before the Server is built), or explicitly on
`pass_calibration_batches` batches of the iterator that
`pass_calibration_iter` names (pred, train, or an eval block's name).

pred / pred_raw / serve need `model_in = <checkpoint>` (the JAX
package's native format) and a `pred = <file>` iterator block. `dev`
picks the device: `cpu` is the CPU; `gpu`, `gpu:0`, `cuda` and `tpu`
(the shipped confs' spelling) mean `cuda:0`, the default. extract is
a later slice and raises.

The telemetry plane (telemetry/, docs/OBSERVABILITY.md) arms before
init(): `log_file` / `metrics_file` (JSONL sinks, `log_format`,
`heartbeat_secs`), `metrics_port` / `metrics_host` (the /metrics,
/healthz, /varz, /executables listener), `alert_rules` / `alert_cmd`,
`watchdog_secs` and `flight_recorder`; with none of them set nothing is
armed and the output is unchanged. `publish_model = <path>` copies each
saved checkpoint atomically to a path a serving `swap_watch` polls.
`task = serve` drains on SIGTERM: it stops submitting, resolves every
admitted request into the output file, and exits 0.
"""

from __future__ import annotations

import collections
import os
import re
import sys
import time
from typing import List, Optional, Tuple

import numpy as np

from cxxnet_tpu_torch import kernels, telemetry
from cxxnet_tpu_torch.io import DataBatch, create_iterator
from cxxnet_tpu_torch.nnet.trainer import NetTrainer
from cxxnet_tpu_torch.utils.config import (check_ported, parse_config_file,
                                           validate_known_keys)
from cxxnet_tpu_torch.utils.device import device_from_spec
from cxxnet_tpu_torch.utils.fault import DivergenceError, atomic_writer

TASKS = ("train", "finetune", "pred", "pred_raw", "serve")
_PRED_TASKS = ("pred", "pred_raw", "serve")

# task-level keys of the JAX CLI that the port does not implement yet;
# any value but the inert ones raises NotImplementedError naming the key
_NOT_PORTED = {
    "test_io": ("0",), "elastic": ("0",), "keep_latest": ("0",),
    "test_on_server": ("0",),
    "tuning_cache": ("",),
    "net_type": ("0",),
    "extract_node_name": ("",), "output_format": ("txt",),
    "barrier_secs": ("30",), "leader_lease_secs": ("10",),
    "coord_dir": ("",),
    "elastic_nproc": ("2",), "elastic_respawn": ("1",),
    "elastic_max_generations": ("8",), "elastic_grace_secs": ("5",),
    "elastic_poll_secs": ("0.2",), "elastic_absence_secs": ("60",),
    "elastic_stale_secs": ("60",), "elastic_fault": ("",),
}


class LearnTask:
    def __init__(self) -> None:
        self.task = "train"
        self.name_model_in = "NULL"
        self.name_pred = "pred.txt"
        self.name_model_dir = "models"
        self.num_round = 10
        self.max_round = 1 << 31
        self.start_counter = 0
        self.continue_training = 0
        self.save_period = 1
        self.print_step = 100
        self.eval_train = 1
        self.silent = 0
        self.device = "tpu"
        # depth of the staging prefetch of the train loop
        # (io/prefetch.py); 0 streams batches on the update thread
        self.prefetch_stage = 1
        # task=serve load shape: rows per submitted request (0 = the
        # deterministic ragged cycle that covers every bucket)
        self.serve_rows = 1
        # explicit calibration of the graph passes: which iterator
        # feeds `pass_calibration_batches` batches ("" = pred)
        self.pass_calibration_iter = ""
        self.pass_calibration_batches = 1
        # the config schema check (analysis/schema.py): an unknown key
        # raises ConfigError with a did-you-mean; schema_check = 0
        # bypasses it
        self.schema_check = 1
        # the telemetry plane (telemetry/): JSONL sinks, the live
        # listener, alert rules, the hang watchdog, the flight recorder
        self.log_file = ""
        self.metrics_file = ""
        self.log_format = "json"
        self.heartbeat_secs = 0.0
        self.metrics_port = 0
        self.metrics_host = ""
        self.alert_rules = ""
        self.alert_cmd = ""
        self.watchdog_secs = 0.0
        self.flight_recorder = 0
        # serving publish hook: each saved checkpoint is copied
        # atomically here ("" = off)
        self.name_publish = ""
        self.net_trainer: Optional[NetTrainer] = None
        self.itr_train = None
        self.itr_evals = []
        self.eval_names: List[str] = []
        self.itr_pred = None
        self.cfg: List[Tuple[str, str]] = []
        # index of the first command-line override pair in self.cfg;
        # _split_blocks keeps CLI pairs out of iterator-block scanning
        self._n_file_pairs: Optional[int] = None

    # ------------------------------------------------------------------
    def load_conf(self, path: str, overrides: List[str] = ()) -> None:
        """Parse the conf file, then `k=v` overrides; then, unless
        `schema_check = 0`, reject unknown keys - the file's and the
        command line's separately, so the error names where the typo
        is."""
        for name, val in parse_config_file(path):
            self.set_param(name, val)
        n_file = self._n_file_pairs = len(self.cfg)
        for arg in overrides:
            if "=" in arg:
                name, val = arg.split("=", 1)
                self.set_param(name.strip(), val.strip())
        if self.schema_check:
            validate_known_keys(self.cfg[:n_file], source=path)
            validate_known_keys(self.cfg[n_file:],
                                source="command-line override")

    def run(self, argv: List[str]) -> int:
        if len(argv) < 1:
            sys.stdout.write("Usage: <config> [k=v ...]\n")
            return 0
        self.load_conf(argv[0], argv[1:])
        if self.task not in TASKS:
            raise NotImplementedError(
                f"task = {self.task} is not ported to cxxnet_tpu_torch yet "
                f"(ported: {', '.join(TASKS)})")
        # arm telemetry before init() so model loads are on the record;
        # with no sink key set this returns the process to the disabled
        # (byte-parity) state
        telemetry.configure(
            log_file=self.log_file, metrics_file=self.metrics_file,
            log_format=self.log_format,
            heartbeat_secs=self.heartbeat_secs,
            tags={"device": self.device})
        # the live plane: metrics_port = 0 means OFF on the CLI (an
        # ephemeral bind is programmatic only); with every key unset
        # this imports nothing and starts no thread
        telemetry.arm_observability(
            metrics_port=(self.metrics_port if self.metrics_port > 0
                          else None),
            metrics_host=self.metrics_host,
            alert_rules=self.alert_rules, alert_cmd=self.alert_cmd,
            watchdog_secs=self.watchdog_secs)
        if self.flight_recorder:
            telemetry.get().flight.arm()
        telemetry.event("run_start", task=self.task, conf=argv[0],
                        num_round=self.num_round)
        t_run = time.monotonic()
        try:
            self.init()
            if not self.silent:
                sys.stdout.write("initializing end, start working\n")
            if self.task in ("train", "finetune"):
                self.task_train()
            elif self.task == "pred":
                self.task_predict()
            elif self.task == "pred_raw":
                self.task_predict_raw()
            else:
                self.task_serve()
            return 0
        finally:
            # final snapshot + clean close even on an aborting task
            telemetry.event("run_end", task=self.task,
                            secs=time.monotonic() - t_run)
            telemetry.emit_metrics(kind="final", task=self.task)
            telemetry.close()

    def set_param(self, name: str, val: str) -> None:
        if val == "default":
            return
        check_ported(_NOT_PORTED, name, val)
        if name == "model_in":
            self.name_model_in = val
        if name == "model_dir":
            self.name_model_dir = val
        if name == "num_round":
            self.num_round = int(val)
        if name == "max_round":
            self.max_round = int(val)
        if name == "start_counter":
            self.start_counter = int(val)
        if name == "continue":
            self.continue_training = int(val)
        if name == "save_model":
            self.save_period = int(val)
        if name == "print_step":
            self.print_step = int(val)
        if name == "eval_train":
            self.eval_train = int(val)
        if name == "silent":
            self.silent = int(val)
        if name == "task":
            self.task = val
        if name == "dev":
            device_from_spec(val)  # validates early
            self.device = val
        if name == "serve_rows":
            self.serve_rows = int(val)
        if name == "prefetch_stage":
            self.prefetch_stage = int(val)
        if name == "schema_check":
            self.schema_check = int(val)
        if name == "pass_calibration_iter":
            self.pass_calibration_iter = val
        if name == "log_file":
            self.log_file = val
        if name == "metrics_file":
            self.metrics_file = val
        if name == "log_format":
            self.log_format = val
        if name == "heartbeat_secs":
            self.heartbeat_secs = float(val)
        if name == "metrics_port":
            self.metrics_port = int(val)
        if name == "metrics_host":
            self.metrics_host = val
        if name == "alert_rules":
            self.alert_rules = val
        if name == "alert_cmd":
            self.alert_cmd = val
        if name == "watchdog_secs":
            self.watchdog_secs = float(val)
        if name == "flight_recorder":
            self.flight_recorder = int(val)
        if name == "publish_model":
            self.name_publish = val
        if name == "pass_calibration_batches":
            if int(val) < 1:
                raise ValueError("pass_calibration_batches must be >= 1")
            self.pass_calibration_batches = int(val)
        self.cfg.append((name, val))

    # ------------------------------------------------------------------
    def _split_blocks(self):
        """Segment the flat conf into (defcfg, train, evals, pred):
        defcfg = keys outside any iterator block, train/pred = that
        block's keys, evals = [(eval_name, keys), ...]. Also records
        self.name_pred from the `pred =` line; a `pred=file` on the
        command line renames the output without opening a block."""
        defcfg: List[Tuple[str, str]] = []
        train = None
        evals: List[Tuple[str, List[Tuple[str, str]]]] = []
        pred = None
        cur: Optional[List[Tuple[str, str]]] = None
        evname = ""
        flag = 0
        for idx, (name, val) in enumerate(self.cfg):
            cli = (self._n_file_pairs is not None
                   and idx >= self._n_file_pairs)
            if name in ("data", "eval", "pred") and cli:
                if name == "pred":
                    self.name_pred = val
                continue  # a CLI pair is never a block marker
            if name == "data":
                flag, cur = 1, []
                continue
            if name == "eval":
                flag, cur, evname = 2, [], val
                continue
            if name == "pred":
                self.name_pred = val
                flag, cur = 3, []
                continue
            if name == "iter" and val == "end":
                if flag == 0:
                    raise ValueError("wrong configuration file: "
                                     "`iter = end` outside a block")
                if flag == 1:
                    train = cur
                elif flag == 2:
                    evals.append((evname, cur))
                else:
                    pred = cur
                flag, cur = 0, None
                continue
            (defcfg if cur is None else cur).append((name, val))
        return defcfg, train, evals, pred

    def create_net(self) -> NetTrainer:
        """The trainer from the global section + the train data block
        (the historic spec source), plus the pred block under the
        pred tasks only (iterator-scoped keys like a pred batch_size
        must not reach a training trainer), on the `dev` device. No
        iterator is created here, so a conf whose iterator files do not
        exist still builds its net."""
        defcfg, train, evals, pred = self._split_blocks()
        feed = defcfg + (train or [])
        if self.task in _PRED_TASKS:
            feed = feed + (pred or [])
        net = NetTrainer(device=device_from_spec(self.device))
        for k, v in feed:
            net.set_param(k, v)
        self._check_daug_blocks(net, feed, defcfg, train, evals, pred)
        return net

    @staticmethod
    def _daug_spec(pairs) -> dict:
        """Canonical device-augment normalization spec from conf pairs
        (last-writer-wins): divideby folds into scale exactly as the
        trainer's own alias does, and defaults are filled so an
        explicit `mirror = 0` compares equal to an absent one."""
        spec = {"scale": 1.0, "mirror": "0", "crop_y_start": "-1",
                "crop_x_start": "-1", "image_mean": "", "mean_value": "",
                "input_shape": "", "device_augment": "0"}
        for k, v in pairs:
            if k == "divideby":
                spec["scale"] = 1.0 / float(v)
            elif k == "scale":
                spec["scale"] = float(v)
            elif k == "mean_value":
                # parse so `0, 0, 0` == `0,0,0`, and all-zero == OFF
                # == absent (make_device_augment's own rule)
                vals = tuple(float(t) for t in v.split(","))
                spec[k] = "" if not any(vals) else \
                    ",".join(f"{t:g}" for t in vals)
            elif k in spec:
                spec[k] = v
        return spec

    def _check_daug_blocks(self, net, feed, defcfg, train, evals, pred):
        """device_augment applies ONE normalization spec (the trainer's)
        on the device, but every iterator block feeds it raw pixels. A
        block whose effective spec diverges from the trainer's would be
        silently normalized with the WRONG spec - fail loudly instead
        (the JAX CLI's check, with its messages). Only blocks the
        current task instantiates are checked. `feed` is exactly what
        create_net fed the trainer, so eff IS the trainer's spec."""
        active = []
        if self.task in _PRED_TASKS:
            if pred is not None:
                active.append(("pred", pred))
        else:
            if train is not None:
                active.append(("data", train))
            active.extend((name or "eval", keys) for name, keys in evals)
        eff = self._daug_spec(feed)
        want = "1" if net.device_augment else "0"
        for tag, keys in active:
            bs = self._daug_spec(defcfg + keys)
            flag = "1" if int(bs["device_augment"] or "0") else "0"
            if flag != want:
                raise ValueError(
                    f"device_augment mismatch: the trainer compiled "
                    f"with device_augment={want} but iterator block "
                    f"'{tag}' has device_augment={flag} - raw pixels "
                    "and the in-step augment must agree. Set "
                    "device_augment globally, not per block.")
            if not net.device_augment:
                continue
            for k in ("scale", "mirror", "crop_y_start", "crop_x_start",
                      "image_mean", "mean_value", "input_shape"):
                if bs[k] != eff[k]:
                    raise ValueError(
                        f"device_augment: block '{tag}' has {k}="
                        f"{bs[k]!r} but the trainer's compiled spec "
                        f"has {k}={eff[k]!r}; the in-step augment is "
                        "compiled once - per-block normalization "
                        "divergence cannot be honored (use the host "
                        "pipeline, device_augment=0, for that)")

    def init(self) -> None:
        if self.task in ("train", "finetune"):
            self._init_train()
            return
        if self.name_model_in == "NULL":
            raise ValueError(f"task = {self.task} needs model_in = "
                             "<checkpoint>")
        self._timed_load(self.name_model_in)
        defcfg, _train, _evals, pred = self._split_blocks()
        if pred is None:
            raise ValueError("must specify a predict iterator (pred = "
                             "<file> block) to generate predictions")
        self.itr_pred = create_iterator(pred)
        for k, v in defcfg:
            self.itr_pred.set_param(k, v)
        self.itr_pred.init()

    # ------------------------------------------------------------------
    # training (cxxnet_tpu/main.py:524-980)
    # ------------------------------------------------------------------
    def _init_train(self) -> None:
        if self.task == "train" and self.continue_training:
            if not self._sync_latest_model():
                # reference aborts here (cxxnet_main.cpp:109-113)
                raise FileNotFoundError(
                    "Init: cannot find models for continue training; "
                    "specify model_in instead")
            sys.stdout.write(f"Init: Continue training from round "
                             f"{self.start_counter}\n")
        elif self.name_model_in == "NULL":
            if self.task != "train":
                raise ValueError("must specify model_in if not training")
            self.net_trainer = self.create_net()
            self.net_trainer.init_model()
        elif self.task == "finetune":
            self.net_trainer = self.create_net()
            self.net_trainer.init_model()
            with open(self.name_model_in, "rb") as fi:
                self.net_trainer.copy_model_from(fi)
        else:
            self._load_model()
        defcfg, train, evals, _pred = self._split_blocks()
        if train is not None:
            self.itr_train = create_iterator(train)
        for evname, itcfg in evals:
            self.itr_evals.append(create_iterator(itcfg))
            self.eval_names.append(evname)
        for it in [self.itr_train] + self.itr_evals:
            if it is not None:
                for k, v in defcfg:
                    it.set_param(k, v)
                it.init()

    def _model_name(self, counter: int) -> str:
        return os.path.join(self.name_model_dir, f"{counter:04d}.model")

    def _model_counters(self) -> List[int]:
        """Sorted %04d.model counters present in model_dir."""
        try:
            names = os.listdir(self.name_model_dir)
        except OSError:
            return []
        return sorted(int(m.group(1)) for m in
                      (re.fullmatch(r"(\d{4,})\.model", n) for n in names)
                      if m)

    def _sync_latest_model(self) -> bool:
        """Load the newest checkpoint at or past start_counter that
        loads, walking backward past corrupt or truncated files (each
        skip is reported on stderr)."""
        counters = [c for c in self._model_counters()
                    if c >= self.start_counter]
        while counters:
            c = counters.pop()
            path = self._model_name(c)
            t0 = time.perf_counter()
            try:
                tr = self.create_net()
                with open(path, "rb") as fi:
                    tr.load_model(fi)
            except (OSError, ValueError, KeyError) as e:
                telemetry.inc("checkpoint.walkback")
                telemetry.stderr(
                    f"Init: skipping invalid checkpoint {path}: {e}\n",
                    event_kind="checkpoint", op="skip_invalid",
                    path=path, error=str(e))
                continue
            secs = time.perf_counter() - t0
            telemetry.observe("checkpoint.load_s", secs)
            telemetry.event("checkpoint", op="load", path=path, round=c,
                            secs=secs)
            self.net_trainer = tr
            self.start_counter = c + 1
            return True
        return False

    def _timed_load(self, path: str) -> None:
        """The trainer from the conf with `path` loaded into it, its
        load time on the record (`checkpoint.load_s`)."""
        self.net_trainer = self.create_net()
        t0 = time.perf_counter()
        with open(path, "rb") as fi:
            self.net_trainer.load_model(fi)
        secs = time.perf_counter() - t0
        telemetry.observe("checkpoint.load_s", secs)
        telemetry.event("checkpoint", op="load", path=path, secs=secs)

    def _load_model(self) -> None:
        base = os.path.basename(self.name_model_in)
        try:
            self.start_counter = int(base.split(".")[0]) + 1
        except ValueError:
            # one past the newest existing checkpoint, so the next save
            # never overwrites one
            counters = self._model_counters()
            self.start_counter = (counters[-1] + 1 if counters
                                  else self.start_counter + 1)
            sys.stdout.write(
                f"WARNING: cannot infer start_counter from model name; "
                f"using {self.start_counter} (one past the newest "
                f"checkpoint in {self.name_model_dir})\n")
        self._timed_load(self.name_model_in)

    def _save_model(self) -> None:
        # quirk parity: the modulo check uses the POST-incremented
        # counter (cxxnet_main.cpp:173-176)
        counter = self.start_counter
        self.start_counter += 1
        if self.save_period == 0 or self.start_counter % self.save_period:
            return
        os.makedirs(self.name_model_dir, exist_ok=True)
        path = self._model_name(counter)
        t0 = time.perf_counter()
        with atomic_writer(path) as fo:
            self.net_trainer.save_model(fo)
        # end-to-end save cost incl. fsync + rename
        secs = time.perf_counter() - t0
        telemetry.inc("checkpoint.saves")
        telemetry.observe("checkpoint.save_s", secs)
        # a round spent fsyncing a large checkpoint is slow, not hung
        telemetry.beacon("checkpoint.save")
        telemetry.event("checkpoint", op="save", round=counter,
                        path=path, secs=secs,
                        bytes=os.path.getsize(path))
        if self.name_publish:
            # atomic copy to the swap_watch'd path AFTER the round file
            # is durable
            from cxxnet_tpu_torch.nnet import checkpoint
            checkpoint.publish_model(path, self.name_publish)

    def _save_rescue(self) -> str:
        """Rescue checkpoint on a divergence abort: the last good
        (rolled-back) params, in a file resume does not probe."""
        os.makedirs(self.name_model_dir, exist_ok=True)
        path = os.path.join(self.name_model_dir, "rescue.model")
        with atomic_writer(path) as fo:
            self.net_trainer.save_model(fo)
        return path

    def task_train(self) -> None:
        start = time.monotonic()
        if self.continue_training == 0 and self.name_model_in == "NULL":
            self._save_model()
        else:
            line = "".join(self.net_trainer.evaluate(it, name)
                           for it, name in zip(self.itr_evals,
                                               self.eval_names))
            sys.stderr.write(line + "\n")
            sys.stderr.flush()
        if self.itr_train is None:
            return
        try:
            self._train_rounds(self.max_round, start)
        except DivergenceError:
            path = self._save_rescue()
            sys.stderr.write(f"divergence guard: training aborted; rescue "
                             f"checkpoint saved to {path}\n")
            raise
        if not self.silent:
            sys.stdout.write(f"\nupdating end, "
                             f"{int(time.monotonic() - start)} sec in all\n")
            sys.stdout.write(f"kernel launches {kernels.launches()}\n")

    def _train_rounds(self, cc: int, start: float) -> None:
        tr = self.net_trainer
        while self.start_counter <= self.num_round and cc > 0:
            cc -= 1
            if not self.silent:
                sys.stdout.write(f"update round {self.start_counter - 1}\n")
            sample_counter = 0
            itr = self.itr_train
            if self.prefetch_stage > 0:
                # stage batch k+1 (pad + cast + copy) on a worker thread
                # while step k runs (io/prefetch.py)
                itr = tr.prefetch(itr, self.prefetch_stage)
            try:
                itr.before_first()
                while itr.next():
                    tr.update(itr.value())
                    sample_counter += 1
                    if (sample_counter % self.print_step == 0
                            and not self.silent):
                        sys.stdout.write(
                            f"round {self.start_counter - 1:8d}:"
                            f"[{sample_counter:8d}] "
                            f"{int(time.monotonic() - start)} sec "
                            "elapsed\n")
            finally:
                if self.prefetch_stage > 0:
                    # an update() error mid-round must not leak the
                    # worker and its staged device batches
                    itr.close()
            line = f"[{self.start_counter}]"
            if self.eval_train:
                line += tr.eval_train_metric()
            for it, name in zip(self.itr_evals, self.eval_names):
                line += tr.evaluate(it, name)
            sys.stderr.write(line + "\n")
            sys.stderr.flush()
            self._save_model()

    # ------------------------------------------------------------------
    def _write_atomic(self, lines) -> None:
        """Write the prediction file atomically, so a crash never leaves
        a truncated file behind."""
        with atomic_writer(self.name_pred, "w") as fo:
            for line in lines:
                fo.write(line)

    def _calibration_source(self):
        """(iterator, name) behind `pass_calibration_iter`: pred (the
        default), train, or an eval block's name - the latter two built
        from their conf blocks when the task did not build them."""
        name = self.pass_calibration_iter
        if name in ("", "pred"):
            return self.itr_pred, "pred"
        defcfg, train, evals, _pred = self._split_blocks()
        blocks = dict(evals)
        if name == "train":
            block = train
        elif name in blocks:
            block = blocks[name]
        else:
            raise ValueError(
                f"pass_calibration_iter={name!r}: no such iterator (have: "
                "train, pred" + "".join(", " + n for n, _ in evals) + ")")
        if block is None:
            raise ValueError(f"pass_calibration_iter={name!r}: the conf "
                             "has no such iterator block")
        it = create_iterator(block)
        for k, v in defcfg:
            it.set_param(k, v)
        it.init()
        return it, name

    def _calibrate_passes(self) -> bool:
        """Explicit calibration: `pass_calibration_batches` batches of
        the calibration iterator, their statistics pooled. A no-op
        (False) when nothing needs calibration, or when neither several
        batches nor an iterator were asked for - the first inference
        batch then calibrates."""
        tr = self.net_trainer
        if not tr.passes_need_calibration():
            return False
        n = self.pass_calibration_batches
        if n <= 1 and not self.pass_calibration_iter:
            return False
        it, src = self._calibration_source()
        batches = []
        it.before_first()
        while len(batches) < n and it.next():
            b = it.value()
            # iterators may reuse their buffers across next(): copy
            batches.append(DataBatch(
                data=np.array(b.data), label=np.array(b.label),
                inst_index=(None if b.inst_index is None
                            else np.array(b.inst_index)),
                num_batch_padd=b.num_batch_padd))
        it.before_first()
        if not batches:
            return False
        tr.calibrate_graph_passes(batches if len(batches) > 1
                                  else batches[0])
        sys.stdout.write(f"graph_passes: calibrated on {len(batches)} "
                         f"batch(es) from the {src} iterator\n")
        return True

    def task_predict(self) -> None:
        self._calibrate_passes()
        sys.stdout.write("start predicting...\n")

        def lines():
            self.itr_pred.before_first()
            while self.itr_pred.next():
                for v in self.net_trainer.predict(self.itr_pred.value()):
                    yield f"{v:g}\n"
        self._write_atomic(lines())
        sys.stdout.write(f"finished prediction, write into "
                         f"{self.name_pred}\n")

    def task_predict_raw(self) -> None:
        self._calibrate_passes()
        sys.stdout.write("start predicting...\n")

        def lines():
            self.itr_pred.before_first()
            while self.itr_pred.next():
                flat = self.net_trainer.predict_dist(self.itr_pred.value())
                for row in flat:
                    yield " ".join(f"{v:g}" for v in row) + "\n"
        self._write_atomic(lines())
        sys.stdout.write(f"finished prediction, write into "
                         f"{self.name_pred}\n")

    def _serve_request_sizes(self):
        """Row count of each submitted request: serve_rows>0 = fixed;
        serve_rows=0 = a deterministic ragged cycle 1,2,3,5,7,... so a
        single pass exercises every bucket size."""
        if self.serve_rows > 0:
            while True:
                yield self.serve_rows
        cycle = [1, 2, 3, 5, 7, 4, 6, 8]
        i = 0
        while True:
            yield cycle[i % len(cycle)]
            i += 1

    def task_serve(self) -> None:
        """The continuous-batching server warmed over its buckets, then
        the pred iterator replayed as a request stream, with a bounded
        in-flight window so results stream to the file in submission
        order."""
        import signal
        import threading
        from cxxnet_tpu_torch.serve import (QueueFullError, Server,
                                            predictions_from_rows)
        tr = self.net_trainer
        if not self._calibrate_passes() and tr.passes_need_calibration():
            # the Server serves the graph of the calibration epoch it is
            # built at: calibrate on the first pred batch first
            self.itr_pred.before_first()
            if self.itr_pred.next():
                tr.calibrate_graph_passes(self.itr_pred.value())
                sys.stdout.write("serve: calibrated graph passes on the "
                                 "first pred batch\n")
        srv = Server(tr, device=str(tr.device))
        sys.stdout.write(f"serve: warming {len(srv.buckets)} buckets "
                         f"{list(srv.buckets)}\n")
        srv.warmup()
        sys.stdout.write("serve: warmup done, start serving\n")
        kernels.reset_launches()
        # graceful drain on SIGTERM: the handler only sets an Event -
        # the loop stops submitting, every admitted request resolves
        # into the output file, and the task exits 0
        term = threading.Event()
        old_term = None
        try:
            old_term = signal.signal(signal.SIGTERM,
                                     lambda signum, frame: term.set())
        except ValueError:
            pass  # not the main thread (embedded run): no handler
        sizes = self._serve_request_sizes()
        futures: collections.deque = collections.deque()
        max_inflight = 4 * srv.max_batch
        t0 = time.monotonic()

        def lines():
            def drain(down_to: int):
                while len(futures) > down_to:
                    for v in predictions_from_rows(
                            futures.popleft().result()):
                        yield f"{v:g}\n"
            self.itr_pred.before_first()
            while not term.is_set() and self.itr_pred.next():
                batch = self.itr_pred.value()
                valid = batch.batch_size - batch.num_batch_padd
                data = batch.data[:valid]
                lo = 0
                while lo < valid and not term.is_set():
                    n = min(next(sizes), valid - lo)
                    try:
                        futures.append(srv.submit(data[lo:lo + n]))
                    except QueueFullError as e:
                        # serve_queue_limit below the in-flight window:
                        # honor the advice, drain, resubmit - no row
                        # may drop
                        yield from drain(max_inflight // 2)
                        time.sleep(min(e.retry_after_s, 0.5))
                        continue
                    lo += n
                    yield from drain(max_inflight)
            # on completion AND on SIGTERM: every admitted future
            # resolves into the output file
            yield from drain(0)

        srv.start()
        try:
            self._write_atomic(lines())
        finally:
            if old_term is not None:
                signal.signal(signal.SIGTERM, old_term)
            if term.is_set():
                sys.stdout.write("serve: SIGTERM - draining queued "
                                 "requests\n")
                stats = srv.drain()
            else:
                stats = srv.stop()
        dt = time.monotonic() - t0
        qps = stats["requests"] / dt if dt > 0 else 0.0
        sys.stdout.write(
            f"serve: {stats['requests']} requests ({stats['rows']} rows) "
            f"in {dt:.2f} sec, {qps:.1f} req/s, "
            f"p50 {stats['latency_p50_ms']} ms, "
            f"p99 {stats['latency_p99_ms']} ms, "
            f"{stats['padding_rows']} padding rows over "
            f"{stats['batches']} batches, kernel launches "
            f"{kernels.launches()}\n")
        sys.stdout.write(f"finished serving, write into {self.name_pred}\n")


def main(argv: Optional[List[str]] = None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    return LearnTask().run(argv)


if __name__ == "__main__":
    sys.exit(main())
