"""Extra input nodes (`extra_data_num`, nodes in_1..in_k) in the port,
held to the JAX package on the CPU with the conf of
tests/test_trainer.py:505-523 (EXTRA_NET of tests/torch_port_util.py):
the trainer trains and predicts on DataBatch.extra_data, a batch
missing its extras raises with the JAX message, and the Server and
`/predict` take extras with the JAX Server's codes, keys and rows.

Weights cross from the JAX trainer (`carry`). Tolerances: training
steps at STEP_TOL (rtol 1e-4 / atol 1e-5, tests/test_torch_train.py:
XLA:CPU and torch sum the float32 products in other orders), served and
predicted rows at JAX_TOL (rtol 1e-4 / atol 1e-5, tests/
test_torch_serve.py), the port against itself at rtol 1e-5 / atol
1e-6."""

import json
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from cxxnet_tpu.io.data import DataBatch as JaxBatch
from cxxnet_tpu.nnet.trainer import NetTrainer as JaxTrainer
from cxxnet_tpu.serve import Server as JaxServer
from cxxnet_tpu.utils.config import parse_config_string
from cxxnet_tpu_torch.io.data import DataBatch
from cxxnet_tpu_torch.nnet.trainer import NetTrainer
from cxxnet_tpu_torch.serve import Server
from torch_port_util import EXTRA_NET, carry, extra_batches

STEP_TOL = dict(rtol=1e-4, atol=1e-5)
JAX_TOL = dict(rtol=1e-4, atol=1e-5)
SELF_TOL = dict(rtol=1e-5, atol=1e-6)


def _pair():
    jt = JaxTrainer()
    for k, v in parse_config_string(EXTRA_NET):
        jt.set_param(k, v)
    jt.init_model()
    pt = NetTrainer(cfg=EXTRA_NET, device="cpu")
    pt.init_model()
    carry(jt, pt)
    return jt, pt


def _params(tr, jax_side):
    if jax_side:
        return jax.tree.map(np.asarray, tr.state["params"])
    return {lk: {pn: t.numpy() for pn, t in d.items()}
            for lk, d in tr.state["params"].items()}


def test_extra_net_node_shapes_match_jax():
    jt, pt = _pair()
    assert pt.net.node_shapes == [tuple(s) for s in jt.net.node_shapes]
    assert pt.net.node_shapes[1] == (8, 1, 1, 4)


def test_extra_net_trains_and_predicts_like_jax():
    jt, pt = _pair()
    for x, e, y in extra_batches(12, 6):
        jt.update(JaxBatch(data=x, label=y, extra_data=[e]))
        pt.update(DataBatch(data=x, label=y, extra_data=[e]))
        want, got = _params(jt, True), _params(pt, False)
        for lk in want:
            for pn in want[lk]:
                np.testing.assert_allclose(got[lk][pn], want[lk][pn],
                                           **STEP_TOL)
    assert pt.eval_train_metric() == jt.eval_train_metric()
    (x, e, y), = extra_batches(1, 7)
    want = jt.predict_dist(JaxBatch(data=x, label=y, extra_data=[e]))
    got = pt.predict_dist(DataBatch(data=x, label=y, extra_data=[e]))
    np.testing.assert_allclose(got, want, **JAX_TOL)
    pred = pt.predict(DataBatch(data=x, label=y, extra_data=[e]))
    assert (pred == y.reshape(-1)).mean() >= 0.75
    # a short batch pads data and extras alike
    want = jt.predict_dist(JaxBatch(data=x[:5], label=y[:5],
                                    extra_data=[e[:5]]))
    got = pt.predict_dist(DataBatch(data=x[:5], label=y[:5],
                                    extra_data=[e[:5]]))
    np.testing.assert_allclose(got, want, **JAX_TOL)
    # the extra input, not the data, decides: in_1 is really fed
    other = pt.predict_dist(DataBatch(data=x, label=y,
                                      extra_data=[-e]))
    assert not np.allclose(other, pt.predict_dist(
        DataBatch(data=x, label=y, extra_data=[e])))


def test_extra_node_extract_and_staged_update_match():
    jt, pt = _pair()
    (x, e, y), = extra_batches(1, 3)
    for node in ("in_1", "2", "top[-2]"):
        want = jt.extract_feature(JaxBatch(data=x, label=y,
                                           extra_data=[e]), node)
        got = pt.extract_feature(DataBatch(data=x, label=y,
                                           extra_data=[e]), node)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **JAX_TOL)
    # a staged update (stage_batch, the prefetcher's path) is the
    # streamed one
    pt2 = NetTrainer(cfg=EXTRA_NET, device="cpu")
    pt2.init_model()
    carry(jt, pt2)
    for x, e, y in extra_batches(3, 4):
        pt.update(DataBatch(data=x, label=y, extra_data=[e]))
        pt2.update(pt2.stage_batch(DataBatch(data=x, label=y,
                                             extra_data=[e])))
    for lk, d in pt.state["params"].items():
        for pn, t in d.items():
            assert np.array_equal(t.numpy(),
                                  pt2.state["params"][lk][pn].numpy())


def test_missing_extra_raises_with_the_jax_message():
    jt, pt = _pair()
    x, _e, y = extra_batches(1, 1)[0]
    errs = []
    for tr, cls in ((jt, JaxBatch), (pt, DataBatch)):
        for call in (tr.update, tr.predict):
            with pytest.raises(ValueError, match="extra_data_num") as ei:
                call(cls(data=x, label=y))
            errs.append(str(ei.value))
    assert errs[:2] == errs[2:]
    assert pt.epoch == 0 and pt._step_counter == 0


def _post(port, payload):
    r = urllib.request.Request(
        f"http://127.0.0.1:{port}/predict",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        resp = urllib.request.urlopen(r, timeout=60)
        return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as ex:
        return ex.code, json.loads(ex.read())


def test_server_and_predict_with_extras_match_jax():
    jt, pt = _pair()
    reqs = [extra_batches(1, 20 + i, rows=n)[0]
            for i, n in enumerate((1, 3, 8, 5, 2, 11))]
    script = [
        ("ok", {"data": reqs[1][0].reshape(3, -1).tolist(),
                "extras": [reqs[1][1].tolist()], "raw": True}),
        ("one", {"data": reqs[0][0].reshape(-1).tolist(),
                 "extras": [reqs[0][1].tolist()]}),
        ("no_extras", {"data": reqs[1][0].tolist()}),
        ("misaligned", {"data": reqs[1][0].tolist(),
                        "extras": [reqs[0][1].tolist()]}),
        ("too_many", {"data": reqs[0][0].tolist(),
                      "extras": [reqs[0][1].tolist()] * 2}),
        ("not_numeric", {"data": reqs[0][0].tolist(),
                         "extras": ["nonsense"]}),
    ]
    outs, posts, errs = [], [], []
    for cls, tr, kw in ((JaxServer, jt, {}),
                        (Server, pt, {"device": "cpu"})):
        srv = cls(tr, max_batch=8, max_wait_ms=1.0, replicas=2,
                  http_port=0, metrics_host="127.0.0.1", **kw)
        srv.warmup()
        with srv:
            futs = [srv.submit(x, [e]) for x, e, _ in reqs]
            outs.append([np.asarray(f.result(timeout=120)) for f in futs])
            port = srv.metrics_server.port
            posts.append({name: _post(port, body)
                          for name, body in script})
            bad = []
            for args in ((reqs[1][0],), (reqs[1][0], [reqs[0][1]])):
                with pytest.raises(ValueError) as ei:
                    srv.submit(*args)
                bad.append(str(ei.value))
            errs.append(bad)
    for (x, e, y), want, got in zip(reqs, *outs):
        assert got.shape == want.shape == (x.shape[0], 2)
        np.testing.assert_allclose(got, want, **JAX_TOL)
        ref = pt.predict_dist(DataBatch(data=x[:8], label=y[:8],
                                        extra_data=[e[:8]]))
        np.testing.assert_allclose(got[:8], ref, **SELF_TOL)
    assert errs[0] == errs[1]
    want, got = posts
    for name, _ in script:
        (wc, wb), (gc, gb) = want[name], got[name]
        assert gc == wc, (name, gc, wc, gb)
        assert sorted(gb) == sorted(wb), name
        if gc == 200:
            assert gb["predictions"] == wb["predictions"], name
            if "outputs" in wb:
                np.testing.assert_allclose(np.asarray(gb["outputs"]),
                                           np.asarray(wb["outputs"]),
                                           **JAX_TOL)
        else:
            assert gb["error"] == wb["error"], name
    assert got["ok"][0] == 200 and got["no_extras"][0] == 400


def test_mis_shaped_extra_is_refused_at_submit():
    """An extra whose rows are not the node's (c, y, x) is refused at
    submit: 400 over HTTP, and the request beside it is served. The JAX
    Server admits it and fails it at dispatch (500), together with the
    requests batched beside it - the one code the port changes, and
    for a request that never succeeds."""
    jt, pt = _pair()
    (x, e, _y), = extra_batches(1, 2, rows=3)
    flat = {"data": x.tolist(), "extras": [e.reshape(3, 4).tolist()]}
    codes = []
    for cls, tr, kw in ((JaxServer, jt, {}),
                        (Server, pt, {"device": "cpu"})):
        srv = cls(tr, max_batch=8, max_wait_ms=1.0, replicas=1,
                  http_port=0, metrics_host="127.0.0.1", **kw)
        srv.warmup()
        with srv:
            codes.append(_post(srv.metrics_server.port, flat)[0])
            if cls is Server:
                with pytest.raises(ValueError, match="must be rows of"):
                    srv.submit(x, [np.zeros((3, 5), np.float32)])
                with pytest.raises(ValueError, match="row-aligned"):
                    srv.submit(x, [np.float32(1.0)])
                rows = srv.submit(x, [e]).result(timeout=60)
    assert codes == [500, 400]
    np.testing.assert_allclose(rows, pt.predict_dist(DataBatch(
        data=x, label=_y, extra_data=[e])), **SELF_TOL)
