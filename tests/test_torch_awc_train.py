"""The port's WC-DNN training (paper §4.2–4.3) held against the JAX
reference: ``forward`` and ``set_normalization`` on the same weights,
checkpoints read across the two packages, ``train`` from the same initial
parameters (the loss history and the validation error), and the DSD-Sim
label sweep (``generate_dataset``) row for row.

Tolerances: the network's outputs and statistics atol/rtol 1e-5 (float32,
sum order only); the training history and parameters after 5 epochs 1e-4
(float32 AdamW steps on the same batches); the dataset exactly (the same
host code on the same seeds)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.awc import dataset as jdata
from repro.core.awc import model as jm
from repro.core.awc import train as jt
from repro_torch.core.awc import dataset as tdata
from repro_torch.core.awc import model as tm
from repro_torch.core.awc import train as tt

TOL = dict(atol=1e-5, rtol=1e-5)
HIST_TOL = dict(atol=1e-4, rtol=1e-4)


def _ref_params(seed=0, hidden=32):
    """Reference init as numpy leaves, normalization off identity."""
    p = jax.device_get(jm.init(jax.random.PRNGKey(seed), hidden=hidden))
    rng = np.random.default_rng(seed)
    return p._replace(feat_mean=rng.normal(size=7).astype(np.float32),
                      feat_std=(1 + rng.random(7)).astype(np.float32),
                      b_in=(0.1 * rng.normal(size=hidden)).astype(
                          np.float32))


def _tensors(p):
    return tm.WCDNNParams(*jax.tree.map(
        lambda a: torch.from_numpy(np.array(a)), tuple(p)))


def _rows(n, seed=1):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 7)).astype(np.float32) * [2, .3, 20, 30, 3, .4,
                                                     1]
    X = X.astype(np.float32)
    y = (4 + X[:, 0] - 0.05 * X[:, 2] + 0.1 * rng.normal(size=n)).astype(
        np.float32)
    return X, y


def test_forward_and_normalization_match_reference():
    p = _ref_params()
    X, _ = _rows(50)
    want = jm.forward(jax.tree.map(jnp.asarray, p), jnp.asarray(X))
    got = tm.forward(_tensors(p), torch.from_numpy(X))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    jn = jm.set_normalization(p, jnp.asarray(X))
    tn = tm.set_normalization(_tensors(p), torch.from_numpy(X))
    np.testing.assert_allclose(tn.feat_mean.numpy(),
                               np.asarray(jn.feat_mean), **TOL)
    np.testing.assert_allclose(tn.feat_std.numpy(),
                               np.asarray(jn.feat_std), **TOL)
    const = np.ones((4, 7), np.float32)
    assert float(tm.set_normalization(_tensors(p), torch.from_numpy(
        const)).feat_std.min()) == pytest.approx(1e-3)
    predict = tm.numpy_predictor(tn)
    out = tm.forward(tn, torch.from_numpy(X)).numpy()
    assert max(abs(predict(list(r)) - o) for r, o in zip(X, out)) < 1e-5


def test_port_init_is_seeded_and_shaped_as_the_reference():
    a, b = tm.init(3, hidden=16, n_blocks=3), tm.init(3, hidden=16,
                                                     n_blocks=3)
    ref = jm.init(jax.random.PRNGKey(0), hidden=16, n_blocks=3)
    for x, y, r in zip(jax.tree.leaves(tuple(a)), jax.tree.leaves(tuple(b)),
                       jax.tree.leaves(tuple(ref))):
        assert torch.equal(x, y) and tuple(x.shape) == r.shape
        assert x.dtype == torch.float32
    assert float(a.b_out[0]) == 4.0 and float(a.feat_std.min()) == 1.0


def test_checkpoints_cross_packages(tmp_path):
    """The port's ``save`` writes the reference's layout (its ``load`` reads
    it back equal), and the port's ``load`` reads the reference's file."""
    p = _ref_params(seed=2)
    tm.save(_tensors(p), str(tmp_path / "port.npz"))
    jm.save(p, str(tmp_path / "ref.npz"))
    for got in (jm.load(str(tmp_path / "port.npz")),
                tm.load(str(tmp_path / "ref.npz"))):
        for a, b in zip(jax.tree.leaves(tuple(got)),
                        jax.tree.leaves(tuple(p))):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    z1, z2 = np.load(tmp_path / "port.npz"), np.load(tmp_path / "ref.npz")
    assert sorted(z1.files) == sorted(z2.files)
    assert all(z1[k].dtype == z2[k].dtype for k in z1.files)


def test_train_from_the_same_weights_gives_the_reference_history():
    """5 epochs of ``train`` (seeded split and batch order, normalization
    from the training rows, AdamW with the statistics' gradient zeroed),
    both packages from the same initial parameters: the per-epoch L1
    history, the validation error and the final parameters."""
    X, y = _rows(300)
    cfg = dict(epochs=5, batch_size=64, hidden=32)
    p0 = _ref_params(seed=4, hidden=32)
    orig = jm.init
    try:
        jm.init = lambda *a, **k: jax.tree.map(jnp.asarray, p0)
        jp, jinfo = jt.train(X, y, jt.TrainConfig(**cfg))
    finally:
        jm.init = orig
    tp, tinfo = tt.train(X, y, tt.TrainConfig(**cfg), init_params=p0,
                         device="cpu")
    np.testing.assert_allclose(tinfo["history"], jinfo["history"],
                               **HIST_TOL)
    np.testing.assert_allclose(tinfo["val_mae"], jinfo["val_mae"],
                               **HIST_TOL)
    assert (tinfo["n_train"], tinfo["n_val"]) == (jinfo["n_train"],
                                                  jinfo["n_val"])
    assert tinfo["history"][-1] < tinfo["history"][0]
    for a, b in zip(jax.tree.leaves(tuple(tp)), jax.tree.leaves(tuple(jp))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **HIST_TOL)
    if not torch.cuda.is_available():      # no device named: the card
        with pytest.raises(RuntimeError, match="CUDA"):
            tt.train(X, y, tt.TrainConfig(**cfg))


def _scenario(mod):
    """One cut-down scenario: few requests, the default grid's first."""
    return dataclasses.replace(mod.default_grid(small=True)[0],
                               num_requests=12, num_drafters=8)


def test_generate_dataset_rows_equal_reference():
    """``generate_dataset`` (the γ sweep plus fused, soft labels) and
    ``generate_dataset_v2`` (the shifted-bootstrap sweep) on one cut-down
    scenario: X and y equal the reference's exactly, and so do the
    sweeps' objectives and winners."""
    jscn, tscn = _scenario(jdata), _scenario(tdata)
    assert dataclasses.asdict(jscn) == dataclasses.asdict(tscn)
    for jfn, tfn, kw in ((jdata.generate_dataset, tdata.generate_dataset,
                          dict(max_rows_per_scenario=40)),
                         (jdata.generate_dataset_v2,
                          tdata.generate_dataset_v2, {})):
        jX, jy, jres = jfn([jscn], **kw)
        tX, ty, tres = tfn([tscn], **kw)
        assert len(tX) > 0
        np.testing.assert_array_equal(tX, jX)
        np.testing.assert_array_equal(ty, jy)
        assert [r.gamma for r in tres] == [r.gamma for r in jres]
        assert [r.per_gamma for r in tres] == [r.per_gamma for r in jres]


def test_train_default_and_save_writes_only_the_given_path(tmp_path):
    """End to end on the CPU into a temporary path: the default checkpoint
    (which the serving path's ``default_predictor`` would pick up) is not
    written, and the saved net predicts as the trained one."""
    path = tmp_path / "wcdnn.npz"
    params, info = tt.train_default_and_save(
        scenarios=[_scenario(tdata)], path=str(path), small=True,
        device="cpu")
    assert path.exists() and not os.path.exists(tm.DEFAULT_CKPT)
    assert np.isfinite(info["val_mae"])
    predict = tm.numpy_predictor(tm.load(str(path)))
    feats = [1.0, 0.6, 10.0, 20.0, 4.0, 0.0, 1.0]
    with torch.no_grad():
        want = float(tm.forward(params, torch.tensor([feats]))[0])
    assert predict(feats) == pytest.approx(want, rel=1e-5, abs=1e-5)
