"""PyTorch port, the training path on the CPU, second part
(``tests/test_torch_train.py`` has the first and the tolerances,
``tests/test_torch_train_c.py`` jamba-1.5-large-398b and the loop):
``lm.loss_fn`` and its gradients against the JAX package's for four more
architectures; remat changing nothing; and the two kernels' autograd
Functions, their backward (plain PyTorch) against autograd through the
plain versions, with the kernel's forward stood in by its plain version
(the CPU has no kernels; ``tests/test_torch_gpu_train.py`` runs the
kernels on a card).

Tolerances of the Functions' gradients: f32 ``FN_F32_TOL`` = 1e-5 and
bf16 ``FN_BF16_TOL`` = 2e-2 (max |Δ| / max |ref|): the backward
recomputes the dense oracle where autograd differentiates the tiled
plain version (f32 sums in another order), and bf16 gradients round
once.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attn import kernel as FK  # noqa: E402
from repro_torch.kernels.flash_attn import ref as FR  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel as SK  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ref as SR  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from test_torch_train import check_loss_and_grads, torch_one_thread  # noqa: E402,F401

FN_F32_TOL = 1e-5
FN_BF16_TOL = 2e-2

ARCHS = ("mamba2-780m", "llama-3.2-vision-90b", "dbrx-132b", "mixtral-8x22b")


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, monkeypatch, torch_one_thread):
    check_loss_and_grads(arch, monkeypatch)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "jamba-1.5-large-398b"])
def test_remat_changes_nothing(arch, torch_one_thread):
    """``remat`` recomputes each repetition in the backward: the loss and
    every gradient equal the run that keeps the activations, bit for
    bit, and the plain versions run again in the recompute."""
    cfg = get_config(arch, reduced=True)
    model = lm.init_params(cfg, 5, device="cpu")
    g = np.random.default_rng(2)
    tok = torch.from_numpy(g.integers(0, cfg.vocab, (2, 32)).astype(np.int32))
    batch = {"tokens": tok, "labels": torch.roll(tok, -1, 1)}
    calls = {"flash": 0, "ssd": 0}
    orig_f, orig_s = FR.flash_attention_ref, SR.ssd_chunk_scan_ref

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped
    out = {}
    for remat in (False, True):
        calls.update(flash=0, ssd=0)
        FR.flash_attention_ref = count("flash", orig_f)
        SR.ssd_chunk_scan_ref = count("ssd", orig_s)
        try:
            loss, _ = lm.loss_fn(model, batch, remat=remat)
            grads = torch.autograd.grad(loss, list(model.parameters()))
        finally:
            FR.flash_attention_ref, SR.ssd_chunk_scan_ref = orig_f, orig_s
        out[remat] = (loss, grads, dict(calls))
    attn = sum(s.mixer == "attn" for s in cfg.pattern) * cfg.repeats
    mamba = sum(s.mixer == "mamba" for s in cfg.pattern) * cfg.repeats
    assert out[False][2] == {"flash": attn, "ssd": mamba}
    assert out[True][2] == {"flash": 2 * attn, "ssd": 2 * mamba}
    assert torch.equal(out[False][0], out[True][0])
    for a, b in zip(out[False][1], out[True][1]):
        assert torch.equal(a, b)


# ------------------------------------------- the kernels' autograd Functions


def _flash_grads(fn, q, k, v, seed=4, **kw):
    """``fn``'s output and the gradients of a seeded weighted sum of it."""
    q, k, v = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    out = fn(q, k, v, **kw)
    w = torch.randn(out.shape, generator=torch.Generator().manual_seed(seed))
    return (out, *torch.autograd.grad((out.float() * w).sum(), (q, k, v)))


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,dv,causal,window,dtype", [
    (2, 4, 2, 32, 32, 16, 16, True, 0, torch.float32),
    (2, 4, 2, 32, 32, 16, 16, True, 0, torch.bfloat16),
    (1, 2, 2, 70, 70, 8, 8, True, 24, torch.float32),
    (1, 4, 1, 16, 48, 16, 16, False, 0, torch.bfloat16),      # cross: Sk > Sq
    (1, 4, 4, 40, 40, 24, 16, True, 0, torch.float32),        # MLA: dv < d
])
def test_flash_function_backward_matches_plain(monkeypatch, b, hq, hkv, sq, sk, d, dv,
                                               causal, window, dtype):
    """``FlashAttention`` (the kernel backend, its forward the plain
    version here) through ``gqa``'s ``[B, S, H, D]`` -> ``[B, H, S, D]``
    views (and MLA's strided slice of v): the gradients come back in the
    caller's layout and equal autograd through the plain version."""
    calls = []
    monkeypatch.setattr(FK, "flash_attention", lambda *a, **kw: calls.append(1) or
                        FR.flash_attention_ref(*a, **kw))
    monkeypatch.setattr(build, "use_kernel", lambda backend, x: backend == "kernel")
    g = torch.Generator().manual_seed(9)
    q = torch.randn(b, sq, hq, d, generator=g).to(dtype)
    k = torch.randn(b, sk, hkv, d, generator=g).to(dtype)
    kv = torch.randn(b, sk, hkv, d + dv, generator=g).to(dtype)

    def through(backend):
        def attend(q, k, kv):
            v = kv[..., d:]                     # a strided slice, as MLA's
            return A.gqa(q, k, v, causal=causal, window=window, backend=backend)
        return attend
    want = _flash_grads(through("plain"), q, k, kv)
    got = _flash_grads(through("kernel"), q, k, kv)
    assert calls == [1]
    tol = FN_BF16_TOL if dtype == torch.bfloat16 else FN_F32_TOL
    for w, t in zip(want, got):
        assert t.shape == w.shape and t.dtype == w.dtype
        w, t = w.detach().double(), t.detach().double()
        err = float((w - t).abs().max() / w.abs().max())
        assert err < tol


@pytest.mark.parametrize("bh,bg,L,P,N,chunk,bc_dtype", [
    (6, 2, 32, 8, 16, 16, torch.bfloat16),      # group form, bf16 B/C
    (4, 4, 48, 4, 8, 16, torch.float32),
])
def test_ssd_function_backward_matches_plain(monkeypatch, bh, bg, L, P, N, chunk, bc_dtype):
    """``SSDChunkScan``'s gradients for x, loga and B/C in group form (each
    group row's gradient summed over the heads that read it) equal
    autograd through ``ssd_chunk_scan_ref``, for all three outputs."""
    calls = []
    monkeypatch.setattr(build, "use_kernel", lambda backend, x: backend == "kernel")
    monkeypatch.setattr(SK, "ssd_chunk_scan", lambda *a, **kw: calls.append(1) or
                        SR.ssd_chunk_scan_ref(*a, **kw))
    g = torch.Generator().manual_seed(3)
    ins = [torch.randn(bh, L, P, generator=g), -torch.rand(bh, L, generator=g) * 0.5,
           (torch.randn(bg, L, N, generator=g) * 0.3).to(bc_dtype),
           (torch.randn(bg, L, N, generator=g) * 0.3).to(bc_dtype)]
    ws = None
    res = {}
    for name, fn in (("plain", lambda *t: SR.ssd_chunk_scan_ref(*t, chunk=chunk)),
                     ("fn", lambda *t: ssd_ops.ssd_chunk_scan(*t, chunk=chunk))):
        leaves = [t.clone().requires_grad_(True) for t in ins]
        outs = fn(*leaves)
        if ws is None:
            ws = [torch.randn(o.shape, generator=g) for o in outs]
        loss = sum((o * w).sum() for o, w in zip(outs, ws))
        res[name] = (outs, torch.autograd.grad(loss, leaves))
    assert calls == [1]
    for w, t in zip(res["plain"][0] + res["plain"][1], res["fn"][0] + res["fn"][1]):
        assert t.shape == w.shape and t.dtype == w.dtype
        tol = FN_BF16_TOL if t.dtype == torch.bfloat16 else FN_F32_TOL
        w, t = w.detach().double(), t.detach().double()
        assert float((w - t).abs().max() / w.abs().max()) < tol


def test_parameters_are_trainable_and_serving_stays_without_autograd():
    """The forward builds a graph; prefill and decode_step do not."""
    cfg = get_config("mamba2-780m", reduced=True)
    model = lm.init_params(cfg, 0, device="cpu")
    assert all(p.requires_grad for p in model.parameters())
    tok = torch.zeros((1, 8), dtype=torch.int32)
    logits, aux = lm.forward(model, tok)        # the reference's dtypes: bf16 logits
    assert logits.dtype == torch.bfloat16 and logits.shape == (1, 8, cfg.padded_vocab)
    assert aux.dtype == torch.float32 and logits.requires_grad
    logits, caches, clen = lm.prefill(model, tok, 9)
    assert not logits.requires_grad and not any(
        t.requires_grad for c in caches for t in c.values())
    logits, _ = lm.decode_step(model, tok[:, :1], caches, clen + 1)
    assert not logits.requires_grad


@pytest.mark.parametrize("arch,b", [("qwen3-0.6b", 1), ("qwen3-0.6b", 2),
                                    ("mamba2-780m", 1), ("mamba2-780m", 2)])
def test_training_operands_pass_every_wrapper_check(monkeypatch, arch, b):
    """A full-width layer's training forward, remat recompute and backward
    (depth 1, vocab cut: no kernel sees it) with its kernel calls routed
    through the wrappers on the CPU: every operand check passes, so the
    only refusal left is that the tensors are not on a card.  Batch 1
    included: there ``[B, S, H, P] -> [B*H, S, P]`` reshapes to a strided
    view, which the SSD kernel refuses."""
    calls = []

    def rehearse(mod, name, plain):
        orig = getattr(mod, name)

        def wrapper(*args, **kw):
            with pytest.raises(ValueError, match="needs CUDA tensors"):
                orig(*args, **kw)
            calls.append(name)
            return plain(*args, **kw)
        monkeypatch.setattr(mod, name, wrapper)

    rehearse(FK, "flash_attention", FR.flash_attention_ref)
    rehearse(SK, "ssd_chunk_scan", SR.ssd_chunk_scan_ref)
    monkeypatch.setattr(build, "use_kernel", lambda backend, x: backend == "kernel")
    cfg = dataclasses.replace(get_config(arch), n_layers=1, vocab=512)
    model = lm.init_params(cfg, 0, device="cpu")
    tok = torch.from_numpy(np.random.default_rng(1).integers(0, 512, (b, 256)))
    loss, _ = lm.loss_fn(model, {"tokens": tok, "labels": tok})
    torch.autograd.grad(loss, list(model.parameters()))
    want = "ssd_chunk_scan" if arch.startswith("mamba2") else "flash_attention"
    assert calls == [want, want]        # the forward and remat's recompute
