"""Sparse CSR batches (data.h:96-181) in the port, held to the JAX
package on the CPU: the CSR view of DataBatch (SparseInst,
get_row_sparse, to_dense, valid_mask and the dense-batch errors) on the
inputs of tests/test_io.py:284-306, a CSR batch through the trainer's
update / predict / evaluate / extract / calibration (the conf of
tests/test_io.py:309-338, weights carried from the JAX trainer), and
both CLIs' task = pred / serve over a pred iterator that hands out CSR
views. Also the pin of the calibration snapshot that dropped a batch's
extra inputs: EXTRA_NET (tests/torch_port_util.py) under
`graph_passes = quantize_int8` with `pass_calibration_batches = 2`.

Tolerances: the port against the JAX trainer at STEP_TOL (rtol 1e-4 /
atol 1e-5, tests/test_torch_train.py: XLA:CPU and torch sum the float32
products in other orders); a CSR batch against its own dense batch in
the port bit for bit (the densified rows are the same float32 bits);
the CSR view against the JAX package's exactly."""

import os

import jax
import numpy as np
import pytest

from cxxnet_tpu import main as jax_main
from cxxnet_tpu.io.data import DataBatch as JaxBatch
from cxxnet_tpu.nnet.trainer import NetTrainer as JaxTrainer
from cxxnet_tpu.utils.config import parse_config_string
from cxxnet_tpu_torch import main as port_main
from cxxnet_tpu_torch.io.data import DataBatch
from cxxnet_tpu_torch.nnet.trainer import NetTrainer
from torch_port_util import EXTRA_NET, carry, csr_of, extra_batches

STEP_TOL = dict(rtol=1e-4, atol=1e-5)

# tests/test_io.py:284-306: three rows, the second one empty
ROW_PTR = np.array([0, 2, 2, 5], np.int64)
FINDEX = np.array([1, 3, 0, 2, 3], np.uint32)
FVALUE = np.array([1.0, 2.0, 3.0, 4.0, 5.0], np.float32)
LABEL = np.arange(3, dtype=np.float32).reshape(3, 1)
INDEX = np.array([7, 8, 9], np.uint32)

# tests/test_io.py:309-338
FC_CONF = """
netconfig=start
layer[+1:fc1] = fullc:fc1
  nhidden = 4
layer[+0] = softmax
netconfig=end
input_shape = 1,1,6
batch_size = 4
eta = 0.1
metric = error
silent = 1
"""


def _views(**kw):
    """The same CSR batch in both packages."""
    args = dict(label=LABEL, inst_index=INDEX, sparse_row_ptr=ROW_PTR,
                sparse_findex=FINDEX, sparse_fvalue=FVALUE)
    args.update(kw)
    return JaxBatch(**args), DataBatch(**args)


def test_csr_view_rows_match_jax():
    from cxxnet_tpu_torch.io.data import SparseInst
    jb, pb = _views()
    assert pb.is_sparse() and jb.is_sparse()
    assert pb.batch_size == jb.batch_size == 3
    for rid in range(3):
        want, got = jb.get_row_sparse(rid), pb.get_row_sparse(rid)
        assert isinstance(got, SparseInst)
        assert (got.index, got.length) == (want.index, want.length)
        np.testing.assert_array_equal(got.findex, want.findex)
        np.testing.assert_array_equal(got.fvalue, want.fvalue)
        np.testing.assert_array_equal(got.label, want.label)
    assert pb.get_row_sparse(1).length == 0  # the empty row
    # no instance indices: every row's index is 0, as in the JAX package
    jb, pb = _views(inst_index=None)
    assert [pb.get_row_sparse(r).index for r in range(3)] \
        == [jb.get_row_sparse(r).index for r in range(3)] == [0, 0, 0]


@pytest.mark.parametrize("num_features", [4, 3, 6])
def test_csr_to_dense_matches_jax(num_features):
    """4: every index in range; 3: index 3 is dropped; 6: trailing
    zero columns. The empty row densifies to zeros."""
    jb, pb = _views()
    want, got = jb.to_dense(num_features), pb.to_dense(num_features)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == (3, 1, 1, num_features)
    np.testing.assert_array_equal(got, want)
    assert not got[1].any()


@pytest.mark.parametrize("padd", [0, 1, 3])
def test_valid_mask_matches_jax(padd):
    jb, pb = _views(num_batch_padd=padd)
    np.testing.assert_array_equal(pb.valid_mask(), jb.valid_mask())
    dense = np.zeros((5, 1, 1, 2), np.float32)
    np.testing.assert_array_equal(
        DataBatch(data=dense, num_batch_padd=padd).valid_mask(),
        JaxBatch(data=dense, num_batch_padd=padd).valid_mask())


def test_dense_batch_errors_match_jax():
    dense = np.zeros((2, 1, 1, 3), np.float32)
    jb, pb = JaxBatch(data=dense), DataBatch(data=dense)
    assert not pb.is_sparse() and pb.batch_size == 2
    for call in (lambda b: b.get_row_sparse(0), lambda b: b.to_dense(3)):
        msgs = []
        for b in (jb, pb):
            with pytest.raises(ValueError) as ei:
                call(b)
            msgs.append(str(ei.value))
        assert msgs[0] == msgs[1]
    assert pb.densified((1, 1, 3)) is pb


def _fc_batches(seed):
    """(rows, labels, num_batch_padd) of FC_CONF: 3 full batches, then
    a short one of 3 rows whose last is wrap-fill (num_batch_padd = 1).
    About half the entries are zero."""
    rng = np.random.RandomState(seed)
    out = []
    for rows, padd in ((4, 0), (4, 0), (4, 0), (3, 1)):
        x = rng.randn(rows, 6).astype(np.float32)
        x[rng.rand(rows, 6) < 0.5] = 0.0
        y = rng.randint(0, 4, size=(rows, 1)).astype(np.float32)
        out.append((x.reshape(rows, 1, 1, 6), y, padd))
    return out


def _csr_with_stray(x, cls, y, padd):
    """The CSR view of x with an entry at feature 7, past the 6 inputs,
    appended to row 0: both packages drop it."""
    b = csr_of(x, cls, label=y, num_batch_padd=padd)
    ptr = b.sparse_row_ptr.copy()
    a = int(ptr[1])
    b.sparse_findex = np.insert(b.sparse_findex, a, 7).astype(np.uint32)
    b.sparse_fvalue = np.insert(b.sparse_fvalue, a, 9.0).astype(np.float32)
    ptr[1:] += 1
    b.sparse_row_ptr = ptr
    return b


class ListIter:
    """A data iterator over a list of batches."""

    def __init__(self, items):
        self.items = list(items)
        self.i = -1

    def init(self):
        pass

    def set_param(self, name, val):
        pass

    def before_first(self):
        self.i = -1

    def next(self):
        self.i += 1
        return self.i < len(self.items)

    def value(self):
        return self.items[self.i]


def _fc_trainers(conf=FC_CONF):
    jt = JaxTrainer()
    for k, v in parse_config_string(conf):
        jt.set_param(k, v)
    jt.init_model()
    csr = NetTrainer(cfg=conf, device="cpu")
    csr.init_model()
    carry(jt, csr)
    dense = NetTrainer(cfg=conf, device="cpu")
    dense.init_model()
    carry(jt, dense)
    return jt, csr, dense


def _port_params(tr):
    return {lk: {pn: t.numpy().copy() for pn, t in d.items()}
            for lk, d in tr.state["params"].items()}


def test_csr_batch_trains_predicts_evaluates_extracts_like_jax():
    """update x 3 and the short batch, then predict / predict_dist /
    evaluate / extract on each batch: the JAX trainer fed the CSR view
    at STEP_TOL, the port's dense run bit for bit."""
    jt, csr, dense = _fc_trainers()
    data = _fc_batches(11)
    views = [(_csr_with_stray(x, JaxBatch, y, p),
              _csr_with_stray(x, DataBatch, y, p),
              DataBatch(data=x, label=y, num_batch_padd=p))
             for x, y, p in data]
    for jb, pb, db in views:
        jt.update(jb)
        csr.update(pb)
        dense.update(db)
        want, got, own = (jax.tree.map(np.asarray, jt.state["params"]),
                          _port_params(csr), _port_params(dense))
        for lk in want:
            for pn in want[lk]:
                np.testing.assert_allclose(got[lk][pn], want[lk][pn],
                                           **STEP_TOL)
                assert np.array_equal(got[lk][pn], own[lk][pn]), (lk, pn)
    assert csr.eval_train_metric() == dense.eval_train_metric() \
        == jt.eval_train_metric()
    for jb, pb, db in views:
        n = pb.batch_size - pb.num_batch_padd
        for name in ("predict", "predict_dist"):
            got = getattr(csr, name)(pb)
            assert got.shape[0] == n
            assert np.array_equal(got, getattr(dense, name)(db))
            np.testing.assert_allclose(got, getattr(jt, name)(jb),
                                       **STEP_TOL)
        for node in ("fc1", "top[-1]"):
            got = csr.extract_feature(pb, node)
            assert np.array_equal(got, dense.extract_feature(db, node))
            np.testing.assert_allclose(got, jt.extract_feature(jb, node),
                                       **STEP_TOL)
    got = csr.evaluate(ListIter(v[1] for v in views), "test")
    assert got == dense.evaluate(ListIter(v[2] for v in views), "test")
    assert got == jt.evaluate(ListIter(v[0] for v in views), "test")
    # the staged (prefetcher's) path and a fused chunk take CSR batches
    pb, db = views[0][1], views[0][2]
    assert np.array_equal(csr.stage_batch(pb).data.numpy(),
                          dense.stage_batch(db).data.numpy())
    csr.update_chunk([pb, views[1][1]])
    dense.update_chunk([db, views[1][2]])
    own = _port_params(dense)
    for lk, d in _port_params(csr).items():
        for pn, a in d.items():
            assert np.array_equal(a, own[lk][pn]), (lk, pn)


def test_csr_batches_calibrate_like_dense():
    """quantize_int8 calibrated on two CSR batches (the pooled moments
    of calibrate_graph_passes) serves the rows of the dense calibration
    bit for bit, and the JAX trainer's at STEP_TOL."""
    conf = FC_CONF + "graph_passes = quantize_int8\n"
    jt, csr, dense = _fc_trainers(conf)
    data = _fc_batches(12)
    jt.calibrate_graph_passes([csr_of(x, JaxBatch, label=y)
                               for x, y, _ in data[:2]])
    csr.calibrate_graph_passes([csr_of(x, DataBatch, label=y)
                                for x, y, _ in data[:2]])
    dense.calibrate_graph_passes([DataBatch(data=x, label=y)
                                  for x, y, _ in data[:2]])
    for x, y, p in data:
        pb = csr_of(x, DataBatch, label=y, num_batch_padd=p)
        got = csr.predict_dist(pb)
        assert np.array_equal(got, dense.predict_dist(
            DataBatch(data=x, label=y, num_batch_padd=p)))
        np.testing.assert_allclose(got, jt.predict_dist(
            csr_of(x, JaxBatch, label=y, num_batch_padd=p)), **STEP_TOL)


class CsrView:
    """Hands out each batch of `inner` as its CSR view (data None), the
    other fields kept: a user's iterator of CSR batches."""

    def __init__(self, inner, cls):
        self.inner, self.cls = inner, cls

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def value(self):
        b = self.inner.value()
        return csr_of(b.data, self.cls, label=b.label,
                       inst_index=b.inst_index,
                       num_batch_padd=b.num_batch_padd,
                       extra_data=list(b.extra_data))


def _patch_csr(monkeypatch):
    port_make, jax_make = port_main.create_iterator, jax_main.create_iterator
    monkeypatch.setattr(port_main, "create_iterator",
                        lambda block, **kw: CsrView(port_make(block, **kw),
                                                    DataBatch))
    monkeypatch.setattr(jax_main, "create_iterator",
                        lambda block, **kw: CsrView(jax_make(block, **kw),
                                                    JaxBatch))


def _run(main, argv):
    assert main.main(argv) == 0
    out = [a.split("=", 1)[1] for a in argv if a.startswith("pred=")][0]
    with open(out) as f:
        return f.read().splitlines()


def test_cli_pred_and_serve_over_csr_batches(tmp_path, monkeypatch):
    """task = pred and task = serve (a ragged request stream) over a
    pred iterator of the mnist rows' CSR views (every nonzero pixel an
    entry; the densified rows take the net's (1, 28, 28) shape) write
    the dense run's lines, and the JAX CLI's."""
    from test_torch_serve import CLI_CONF, write_mnist
    d = str(tmp_path)
    write_mnist(d, 100, 4)
    conf = os.path.join(d, "net.conf")
    with open(conf, "w") as f:
        f.write(CLI_CONF.format(out=os.path.join(d, "unused.txt"), d=d))
    jt = JaxTrainer(cfg=CLI_CONF.format(out="unused.txt", d=d))
    jt.init_model()
    model = os.path.join(d, "0001.model")
    with open(model, "wb") as fo:
        jt.save_model(fo)

    def argv(task, tag):
        return [conf, f"task={task}", f"model_in={model}",
                f"pred={os.path.join(d, f'{tag}.txt')}", "serve_rows=0"]
    dense = _run(port_main, argv("pred", "dense"))
    jax_dense = _run(jax_main, argv("pred", "jax_dense"))
    _patch_csr(monkeypatch)
    outs = {task: _run(port_main, argv(task, f"csr_{task}"))
            for task in ("pred", "serve")}
    jax_csr = _run(jax_main, argv("pred", "jax_csr"))
    assert len(dense) == 100 and len(set(dense)) > 1
    assert outs["pred"] == outs["serve"] == dense == jax_csr == jax_dense


def _extra_iter(cls, csr):
    """A pred iterator of EXTRA_NET: 3 batches of 8 rows with their
    extra inputs, dense or as CSR views."""
    items = []
    for x, e, y in extra_batches(3, 21):
        items.append(csr_of(x, cls, label=y, extra_data=[e]) if csr
                     else cls(data=x, label=y, extra_data=[e]))
    return ListIter(items)


@pytest.mark.parametrize("csr", [False, True], ids=["dense", "csr"])
def test_cli_calibration_snapshot_keeps_extra_inputs(tmp_path, monkeypatch,
                                                     csr):
    """The CLI's calibration snapshot copies a batch's extra inputs (and
    its CSR view): EXTRA_NET under quantize_int8, calibrated on 2 pred
    batches, predicts the JAX CLI's lines from one JAX checkpoint. The
    port once copied data / label / inst_index / num_batch_padd only, so
    the pooled calibration raised `net declares extra_data_num=1 but the
    batch carries 0 extra arrays`."""
    d = str(tmp_path)
    block = ('pred = {out}\niter = mnist\n  path_img = "none"\n'
             '  path_label = "none"\niter = end\n')
    conf = os.path.join(d, "net.conf")
    with open(conf, "w") as f:
        f.write(block + EXTRA_NET)
    jt = JaxTrainer()
    for k, v in parse_config_string(EXTRA_NET):
        jt.set_param(k, v)
    jt.init_model()
    model = os.path.join(d, "0001.model")
    with open(model, "wb") as fo:
        jt.save_model(fo)
    monkeypatch.setattr(port_main, "create_iterator",
                        lambda block, **kw: _extra_iter(DataBatch, csr))
    monkeypatch.setattr(jax_main, "create_iterator",
                        lambda block, **kw: _extra_iter(JaxBatch, csr))
    outs = {}
    for tag, main in (("port", port_main), ("jax", jax_main)):
        outs[tag] = _run(main, [
            conf, "task=pred", f"model_in={model}", "dev=cpu",
            f"pred={os.path.join(d, tag + '.txt')}",
            "graph_passes=quantize_int8", "pass_calibration_batches=2"])
    assert len(outs["port"]) == 24
    assert outs["port"] == outs["jax"]
