"""The port's serving path against the reference's, on the CPU.

``repro_torch.launch.serve.serve_batch`` from the reference's weights
and prompts (the reference draws both from ``jax.random``; they are
passed across as numpy) gives the reference's greedy tokens exactly, at
float32 compute, for the three archs of ``examples/serve.py``.  The
port's example and launcher run end to end on the CPU, and without a
card an entry point that was not asked for the CPU raises.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget
from repro.launch.serve import serve_batch as jserve_batch
from repro.models.model import Model as JModel
from repro_torch.configs import get_smoke_config
from repro_torch.examples import serve as ex
from repro_torch.launch import serve as tserve
from repro_torch.models.model import Model

torch.set_num_threads(1)

BATCH, PROMPT, GEN = 4, 32, 16


@pytest.mark.parametrize("arch", ex.ARCHS)
def test_serve_batch_tokens_equal_the_reference(arch):
    jcfg = jget(arch).replace(compute_dtype="float32")
    want, _, _ = jserve_batch(jcfg, JModel(jcfg), BATCH, PROMPT, GEN)
    # what the reference's serve_batch drew, seed 0
    params = jax.tree.map(np.asarray, JModel(jcfg).init_params(
        jax.random.key(0)))
    prompts = np.asarray(jax.random.randint(
        jax.random.key(1), (BATCH, PROMPT), 0, jcfg.vocab))
    cfg = get_smoke_config(arch).replace(compute_dtype="float32")
    got, t_p, t_d = tserve.serve_batch(cfg, None, BATCH, PROMPT, GEN,
                                       params=params, prompts=prompts,
                                       device="cpu")
    print(f"{arch}: tokens {got[0].tolist()} (prefill {t_p * 1e3:.1f} ms, "
          f"decode {t_d * 1e3:.1f} ms on the CPU)")
    assert got.dtype == torch.int32 and got.shape == (BATCH, GEN)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_serve_batch_draws_from_its_seed():
    cfg = get_smoke_config("xlstm-125m")
    a = tserve.serve_batch(cfg, None, 2, 8, 4, seed=5, device="cpu")[0]
    m = Model(cfg, device="cpu")
    b = tserve.serve_batch(cfg, m, 2, 8, 4, seed=5, device="cpu")[0]
    assert torch.equal(a, b)
    pre = tserve.prefill_batch(cfg, 2, 8, seed=5, device="cpu")
    assert pre["tokens"].dtype == torch.int32
    assert int(pre["tokens"].max()) < cfg.vocab


def test_example_serve_runs_on_the_cpu(capsys):
    out = ex.main(device="cpu")
    assert sorted(out) == sorted(ex.ARCHS)
    for arch, rec in out.items():
        assert rec["tokens"].shape == (4, 16), arch
        assert int(rec["tokens"].min()) >= 0
        assert int(rec["tokens"].max()) < get_smoke_config(arch).vocab
    assert "serve OK" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["whisper-base", "qwen2-vl-72b",
                                  "deepseek-v3-671b"])
def test_launch_serve_main_on_the_cpu(arch, capsys):
    assert tserve.main(["--arch", arch, "--cpu", "--batch", "2",
                        "--prompt-len", "8", "--gen", "4"]) == 0
    assert f"arch={arch}" in capsys.readouterr().out


def test_entry_points_do_not_fall_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is that card")
    cfg = get_smoke_config("gemma2-2b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.serve_batch(cfg, None, 1, 4, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ex.main()

