"""The port's LM stack against the reference, arch by arch at smoke
size, on the CPU: the dense decoders (gemma3-4b, gemma2-27b, gemma2-2b, granite-3-2b) and
the VLM (qwen2-vl-72b, M-RoPE and the vision stub).

From the reference's weights (``lm_params_from_numpy``) and one
numpy-seeded batch, at float32 compute: forward logits, the loss with
its parts (cross-entropy, MTP, aux), the gradient of every parameter
(autograd against ``jax.grad``), the prefill's logits and four decode
steps' logits; at bfloat16 compute, the same logits and loss at a
looser tolerance.  Tolerances in ``tests/_lm_diff.py``; each test
prints the worst error it saw.  The reference runs jitted, once per
arch and dtype (a module-scoped fixture).
"""
import numpy as np
import pytest
import torch

import _lm_diff as D

torch.set_num_threads(1)

ARCHS = ("gemma3-4b", "gemma2-27b", "gemma2-2b", "granite-3-2b", "qwen2-vl-72b")


@pytest.fixture(scope="module", params=ARCHS)
def f32(request):
    arch = request.param
    ref = D.reference(arch, "float32", grads=True)
    return arch, ref, D.port(arch, "float32", ref, grads=True)


@pytest.fixture(scope="module", params=ARCHS)
def bf16(request):
    arch = request.param
    ref = D.reference(arch, "bfloat16", grads=False)
    return arch, ref, D.port(arch, "bfloat16", ref, grads=False)


def test_forward_logits_f32(f32):
    arch, ref, mine = f32
    err = D.max_err(mine["logits"], ref["logits"])
    print(f"{arch} f32 forward logits: max abs err {err:.3e}")
    assert mine["logits"].shape == ref["logits"].shape
    assert err < D.F32_ATOL


def test_loss_f32(f32):
    arch, ref, mine = f32
    assert sorted(mine["metrics"]) == sorted(ref["metrics"])
    errs = {k: D.max_err(mine["metrics"][k], ref["metrics"][k])
            for k in ref["metrics"]}
    errs["loss"] = abs(mine["loss"] - ref["loss"])
    print(f"{arch} f32 loss {mine['loss']:.6f} (ref {ref['loss']:.6f}); "
          f"errors {errs}")
    assert max(errs.values()) < D.F32_LOSS_ATOL, errs


def test_grads_f32(f32):
    arch, ref, mine = f32
    errs = D.grad_errors(arch, ref, mine)
    worst = max(errs, key=errs.get)
    print(f"{arch} f32 gradients of {len(errs)} parameters: worst "
          f"relative err {errs[worst]:.3e} ({worst})")
    assert errs[worst] < D.GRAD_RTOL


def test_prefill_and_decode_f32(f32):
    arch, ref, mine = f32
    errs = [D.max_err(mine["prefill"], ref["prefill"])] + [
        D.max_err(a, b) for a, b in zip(mine["decode"], ref["decode"])]
    print(f"{arch} f32 prefill, decode logits: max abs errs "
          + ", ".join(f"{e:.3e}" for e in errs))
    assert len(mine["decode"]) == len(ref["decode"]) == D.S - D.PREFILL
    assert max(errs) < D.F32_ATOL


def test_bf16(bf16):
    arch, ref, mine = bf16
    errs = {"forward": D.max_err(mine["logits"], ref["logits"]),
            "prefill": D.max_err(mine["prefill"], ref["prefill"]),
            "decode": max(D.max_err(a, b) for a, b in
                          zip(mine["decode"], ref["decode"]))}
    scale = float(np.max(np.abs(ref["logits"])))
    loss_err = abs(mine["loss"] - ref["loss"])
    print(f"{arch} bf16 logits max abs errs {errs} (logits up to "
          f"{scale:.2f}); loss err {loss_err:.3e}")
    assert max(errs.values()) < D.BF16_ATOL
    assert loss_err < D.BF16_LOSS_ATOL
