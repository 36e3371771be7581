"""K5's gradient on the CPU: the plain backward ``flash_attention_bwd_ref``
(what ``flash_attention``'s autograd takes on CPU tensors and what
``chip_smoke.py`` holds the ``flash_attention_bwd.cu`` kernel against on
the card) against autograd of the plain forward and against ``jax.vjp`` of
the reference's ``blocked_attend``; the forward's log-sum-exp; the
no-grad forward unchanged; the backward's launch plan.

Tolerances: every gradient within 1e-5 of its own max |grad| in f32 (the
same function, summed in another order: measured ~1e-6); ``lse`` within
1e-5 absolute of the masked ``logsumexp``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import attention as jattention

from repro_torch.core import attention
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                      flash_attention_ref)

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

GRAD_TOL = 1e-5
# (mask_kind, window, q_offset, Sq, Sk): every kind, Sq != Sk, q_offsets
MASKS = [
    ("causal", 0, 0, 37, 37),
    ("causal", 0, 11, 26, 37),
    ("sliding", 8, 0, 40, 40),
    ("sliding", 8, 5, 30, 35),
    ("chunked", 16, 0, 40, 40),
    ("chunked", 16, 5, 30, 35),
    ("full", 0, 0, 20, 50),
    ("prefix_causal", 10, 0, 33, 33),
]
HEADS = [(4, 4), (6, 2), (8, 2)]  # g 1, 3, 4


def _inputs(seed, Sq, Sk, Hq, Hk, D, B=2):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return f(B, Sq, Hq, D), f(B, Sk, Hk, D), f(B, Sk, Hk, D), f(B, Sq, Hq, D)


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= GRAD_TOL, f"{what}: {err:.3e} of max |grad| > {GRAD_TOL}"


def _plain_grads(q, k, v, do, kind, w, off):
    """flash_attention_bwd_ref on the plain forward's out and lse."""
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = flash_attention_ref(tq, tk, tv, mask_kind=kind, window=w, q_offset=off,
                                   return_lse=True)
    return flash_attention_bwd_ref(tq, tk, tv, out, lse, tdo, mask_kind=kind, window=w,
                                   q_offset=off)


# every mask with every group; D 16 and 24 alternate so each mask meets both
CASES = [(m, h, (16, 24)[(i + j) % 2]) for i, m in enumerate(MASKS) for j, h in enumerate(HEADS)]


@pytest.mark.parametrize(
    "mask,heads,D", CASES,
    ids=[f"{m[0]}-w{m[1]}-off{m[2]}-{m[3]}x{m[4]}-g{h[0] // h[1]}-D{D}" for m, h, D in CASES])
def test_plain_backward_matches_autograd_and_jax_vjp(mask, heads, D):
    kind, w, off, Sq, Sk = mask
    q, k, v, do = _inputs(7, Sq, Sk, *heads, D)
    got = _plain_grads(q, k, v, do, kind, w, off)

    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = flash_attention_ref(*leaves, mask_kind=kind, window=w, q_offset=off)
    auto = torch.autograd.grad(out, leaves, torch.from_numpy(do))

    # two key blocks, so the scan carries its online softmax across a block edge
    fn = lambda a, b, c: jattention.blocked_attend(a, b, c, mask_kind=kind, window=w,
                                                   q_offset=off, block_q=64, block_k=32)
    vjp = jax.jit(lambda a, b, c, g: jax.vjp(fn, a, b, c)[1](g))
    jgrads = vjp(*(jnp.asarray(x) for x in (q, k, v, do)))
    for name, g, a, j in zip(("dq", "dk", "dv"), got, auto, jgrads):
        _close(g.numpy(), a.numpy(), f"{name} against autograd")
        _close(g.numpy(), np.asarray(j), f"{name} against jax.vjp(blocked_attend)")


@pytest.mark.parametrize("mask", MASKS, ids=lambda m: f"{m[0]}-w{m[1]}-off{m[2]}")
def test_lse_is_the_masked_logsumexp(mask):
    kind, w, off, Sq, Sk = mask
    q, k, _, _ = _inputs(3, Sq, Sk, 6, 2, 16)
    out, lse = flash_attention_ref(*(torch.from_numpy(a) for a in (q, k, k)), mask_kind=kind,
                                   window=w, q_offset=off, return_lse=True)
    assert lse.shape == (2, 6, Sq) and lse.dtype == torch.float32
    m = np.asarray(jattention.make_mask(kind, Sq, Sk, w, off)) if kind != "prefix_causal" \
        else attention.prefix_causal_mask(Sq, Sk, w, off).numpy()
    qg = q.reshape(2, Sq, 2, 3, 16)
    s = np.einsum("bqhgd,bkhd->bhgqk", qg.astype(np.float64), k.astype(np.float64)) / 4.0
    s = np.where(m, s, -np.inf)
    want = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + s.max(-1)
    assert np.abs(lse.numpy() - want.reshape(2, 6, Sq)).max() <= 1e-5
    assert torch.equal(out, flash_attention_ref(*(torch.from_numpy(a) for a in (q, k, k)),
                                                mask_kind=kind, window=w, q_offset=off))


def test_no_grad_forward_is_unchanged_and_the_grad_path_gives_the_same_out():
    q, k, v, do = _inputs(5, 37, 37, 6, 2, 16)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    plain = flash_attention(tq, tk, tv, mask_kind="sliding", window=8)
    mask = attention.make_mask("sliding", 37, 37, 8)
    assert plain.grad_fn is None
    assert torch.equal(plain, attention.attend(tq, tk, tv, mask=mask))
    assert torch.equal(plain, attention.blocked_attend(tq, tk, tv, mask_kind="sliding", window=8))
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = flash_attention(*leaves, mask_kind="sliding", window=8)
    assert out.grad_fn is not None and torch.equal(out.detach(), plain)
    with torch.no_grad():
        assert flash_attention(*leaves, mask_kind="sliding", window=8).grad_fn is None


@pytest.mark.parametrize("which", [(True, True, True), (True, False, False),
                                   (False, True, True)], ids=["qkv", "q", "kv"])
def test_autograd_routes_through_the_plain_backward(which):
    q, k, v, do = _inputs(9, 30, 35, 8, 2, 24)
    leaves = [torch.from_numpy(a).requires_grad_(r) for a, r in zip((q, k, v), which)]
    out = flash_attention(*leaves, mask_kind="chunked", window=16, q_offset=5)
    out.backward(torch.from_numpy(do))
    want = _plain_grads(q, k, v, do, "chunked", 16, 5)
    for t, w, r in zip(leaves, want, which):
        assert (t.grad is not None) == r
        if r:
            assert torch.equal(t.grad, w)


def test_window_zero_is_causal_in_the_backward():
    q, k, v, do = _inputs(2, 20, 20, 4, 2, 16)
    a = _plain_grads(q, k, v, do, "causal", 0, 0)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    flash_attention(*leaves, mask_kind="sliding", window=0).backward(torch.from_numpy(do))
    for t, w in zip(leaves, a):
        assert torch.equal(t.grad, w)


def test_bf16_gradients_come_back_in_bf16():
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16) for a in _inputs(4, 17, 17, 4, 1, 16))
    out, lse = flash_attention_ref(q, k, v, return_lse=True)
    grads = flash_attention_bwd(q, k, v, out, lse, do)
    assert [g.dtype for g in grads] == [torch.bfloat16] * 3
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]


def test_backward_refuses_mismatched_operands():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(1, 8, 8, 4, 2, 16))
    out, lse = flash_attention_ref(q, k, v, return_lse=True)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(q, k, v, out, lse[:, :, :4], do)
    with pytest.raises(ValueError, match="dout"):
        flash_attention_bwd(q, k, v, out, lse, do[:, :4])
    with pytest.raises(ValueError, match="multiple"):
        flash_attention_bwd(q, k[:, :, :1].expand(-1, -1, 3, -1), v[:, :, :1].expand(-1, -1, 3, -1),
                            out, lse, do)


class TestBackwardPlan:
    @pytest.mark.parametrize("D", [16, 24, 32, 64, 128, 200, 256])
    def test_blocks_fit_an_sm(self, D):
        kv, q = flash_kernel.bwd_smem_bytes(D)
        assert max(kv, q) <= build.MAX_SMEM
        assert flash_kernel.bwd_tile(D) == (32 if D > 128 else 64)

    def test_source_carve_up(self):
        # the .cu's kv_smem_bytes / q_smem_bytes at D 128 and 256
        assert flash_kernel.bwd_smem_bytes(128) == (165_888, 149_248)
        assert flash_kernel.bwd_smem_bytes(256) == (140_288, 136_064)

    def test_grids_cover_every_key_and_query_tile(self):
        p = flash_kernel.bwd_plan(1, 4096, 4096, 24, 8, 128)
        assert p.grid_kv == (64, 8) and p.grid_q == (64, 24) and p.threads == 256
        p = flash_kernel.bwd_plan(2, 128, 1500, 16, 16, 64)
        assert p.grid_kv == (24, 32) and p.grid_q == (2, 32)
        p = flash_kernel.bwd_plan(1, 301, 301, 8, 4, 256)
        assert p.tile == 32 and p.grid_kv == (10, 4) and p.grid_q == (10, 8)

    def test_the_library_declares_the_backward(self):
        src = (build.CSRC / "flash_attention_bwd.cu").read_text()
        assert "int flash_attention_bwd_launch(" in src
        assert "flash_attention.cuh" in src
        fwd = (build.CSRC / "flash_attention.cu").read_text()
        assert "void* lse" in fwd
