"""The DPI model's training and ternarization against the JAX reference,
on the CPU (``repro_torch.kernels.dpi_mlp`` against
``repro.kernels.dpi_mlp``).

* The float SGD loop from the reference's initial weights
  (``init_dpi_params(key(0))``, carried across as numpy) on
  ``make_dataset(2048, seed=0)``, for the 200 steps the secure-flow
  example trains and the default 300: every trained weight and bias
  within ``RTOL`` of the reference's, relative to the leaf's largest
  magnitude (float32 products summed in another order; the worst is
  printed).  The reference's float weights are its own
  ``train_dpi_params`` with its ``ternarize`` stubbed out.
* ``ternarize`` of equal float weights is bit-equal, dtypes included.
* The ternary weights trained from the carried weights equal the
  reference's; an entry that flips would be named with its distance
  from the threshold, which must be below the float tolerance.  Scales
  and biases agree within ``RTOL``.
* The port's own ``train_dpi_params`` (its CPU-generator init) passes
  the reference's accuracy bar, > 0.85 on ``make_dataset(512, seed=2)``
  (``tests/test_kernels.py``), scored by the DPI MLP's plain version.
"""
import jax
import numpy as np
import pytest
import torch

import repro.kernels.dpi_mlp as jdpi
from repro.data.dpi_dataset import make_dataset as jmake_dataset
from repro_torch.data.dpi_dataset import make_dataset
from repro_torch.kernels import dpi_mlp as tdpi
from repro_torch.kernels import ops

torch.set_num_threads(1)

RTOL = 1e-5             # of each leaf's largest magnitude
ACC_BAR = 0.85          # tests/test_kernels.py's bar


@pytest.fixture(scope="module")
def data():
    x, y = make_dataset(2048, seed=0)
    jx, jy = jmake_dataset(2048, seed=0)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    return x, y


@pytest.fixture(scope="module")
def init():
    return {k: np.array(v) for k, v in
            jdpi.init_dpi_params(jax.random.key(0)).items()}


_FLOAT = {}


def _reference_float(x, y, steps):
    """The reference's ``train_dpi_params`` with ``ternarize`` stubbed
    out: its trained float parameters."""
    if steps not in _FLOAT:
        real = jdpi.ternarize
        jdpi.ternarize = lambda p: p
        try:
            p = jdpi.train_dpi_params(x, y, steps=steps)
        finally:
            jdpi.ternarize = real
        _FLOAT[steps] = {k: np.array(v) for k, v in p.items()}
    return _FLOAT[steps]


def _port_float(init, x, y, steps):
    p = tdpi.train_float_dpi_params(init, x, y, steps=steps, device="cpu")
    return {k: v.numpy() for k, v in p.items()}


def _scaled_err(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("steps", [200, 300])
def test_float_loop_matches_reference_from_carried_weights(data, init,
                                                           steps):
    ref = _reference_float(*data, steps)
    got = _port_float(init, *data, steps)
    errs = {k: _scaled_err(got[k], ref[k]) for k in got}
    print(f"{steps} steps: worst |port - ref| / max|ref| per leaf "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + f" (bound {RTOL})")
    assert max(errs.values()) < RTOL
    # the untouched scales stay 1 in both
    assert all(float(ref[f"s{i}"]) == 1.0 for i in (1, 2, 3))


@pytest.mark.parametrize("which", ["init", "trained"])
def test_ternarize_is_bit_equal(data, init, which):
    p = init if which == "init" else _reference_float(*data, 200)
    want = {k: np.asarray(v) for k, v in jdpi.ternarize(p).items()}
    for arg in (p, {k: torch.from_numpy(v) for k, v in p.items()}):
        got = tdpi.ternarize(arg)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert got[k].shape == want[k].shape, k
            assert got[k].tobytes() == want[k].tobytes(), k


def test_trained_ternary_weights_equal_reference(data, init):
    ref_f = _reference_float(*data, 200)
    got_f = _port_float(init, *data, 200)
    ref = {k: np.asarray(v) for k, v in jdpi.ternarize(ref_f).items()}
    got = tdpi.ternarize(got_f)
    flips = []
    for k in ("w1", "w2", "w3"):
        w = ref_f[k]
        thr = 0.7 * np.abs(w).mean()
        for idx in zip(*np.nonzero(got[k] != ref[k])):
            flips.append((k, idx, float(abs(abs(w[idx]) - thr)),
                          RTOL * float(np.abs(w).max())))
    for k, idx, dist, bound in flips:
        print(f"flip {k}{list(idx)}: {dist:.3e} from the threshold "
              f"(float tolerance {bound:.3e})")
    assert all(dist < bound for _, _, dist, bound in flips), flips
    print(f"ternary entries that differ: {len(flips)} of "
          f"{sum(ref[k].size for k in ('w1', 'w2', 'w3'))}")
    for k in ("s1", "s2", "s3", "b1", "b2"):
        assert got[k].dtype == ref[k].dtype == np.float32, k
        assert _scaled_err(got[k], ref[k]) < RTOL, k
    params = tdpi.dpi_params_from_numpy(got, device="cpu")
    assert params["w1"].dtype == torch.int8


def test_port_training_passes_the_accuracy_bar():
    x, y = make_dataset(1024, seed=1)
    p = tdpi.train_dpi_params(x, y, steps=200, device="cpu")
    again = tdpi.train_dpi_params(x, y, steps=200, device="cpu")
    assert all(p[k].tobytes() == again[k].tobytes() for k in p)
    xt, yt = make_dataset(512, seed=2)
    scores = ops.dpi_scores(torch.from_numpy(xt.reshape(len(xt), 64)),
                            tdpi.dpi_params_from_numpy(p, device="cpu"),
                            impl="ref")[:, 0].numpy()
    acc = float(((scores > 0) == (yt > 0.5)).mean())
    print(f"port-trained ternary DPI accuracy {acc:.4f} (bar {ACC_BAR})")
    assert acc > ACC_BAR
    init = tdpi.init_dpi_params(0, device="cpu")
    assert init["w1"].shape == (64, 128) and init["w3"].shape == (64, 1)
    assert torch.equal(init["w2"], tdpi.init_dpi_params(0, "cpu")["w2"])
