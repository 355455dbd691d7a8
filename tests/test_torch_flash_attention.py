"""The port's flash-attention entry point on the CPU (its plain version,
`ref.attention_ref`) against the reference's `fa_ref.attention_ref` and its
Pallas kernel `fa_ops.flash_attention` in interpret mode, on the shapes,
windows and non-causal case of `tests/test_kernels.py`, with the same
inputs made by numpy.  Tolerances as there: 2e-5 relative in fp32, 2e-2 in
bf16 (the kernel and the plain version round differently in bf16)."""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as fa_ops
from repro.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.flash_attention import ops as pt_ops
from repro_torch.kernels.flash_attention import ref as pt_ref

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _err(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-6)


def _np(x):
    return x.float().numpy()


def _inputs(seed, B, Sq, Sk, H, KV, hd, dtype):
    """The same q, k, v in both frameworks (rounded once, to `dtype`)."""
    jdt, tdt, _ = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s, dtype=np.float32)
            for s in ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd))]
    return ([jnp.asarray(a, jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def _check(jx, tx, dtype, **kw):
    tol = DTYPES[dtype][2]
    want = fa_ref.attention_ref(*jx, **kw)
    plain = pt_ref.attention_ref(*tx, **kw)
    before = pt_ops.flash_attention.launches
    got = pt_ops.flash_attention(*tx, **kw)
    assert got.dtype == tx[0].dtype and got.shape == tx[0].shape
    assert pt_ops.flash_attention.launches == before   # CPU: no launch
    assert _err(_np(plain), want) < tol
    assert _err(_np(got), want) < tol
    assert _err(_np(got), fa_ops.flash_attention(*jx, **kw)) < tol


@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd", [
    (1, 128, 128, 2, 2, 64),
    (2, 256, 256, 4, 2, 64),      # GQA groups=2
    (2, 192, 320, 4, 1, 80),      # MQA, ragged seq, odd head_dim
    (1, 512, 512, 8, 8, 128),     # MHA, aligned
    (1, 64, 64, 10, 1, 256),      # recurrentgemma-like heads
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_sweep(B, Sq, Sk, H, KV, hd, dtype):
    jx, tx = _inputs(B * Sq + hd, B, Sq, Sk, H, KV, hd, dtype)
    _check(jx, tx, dtype, causal=True)


@pytest.mark.parametrize("window", [32, 128])
def test_flash_attention_window(window):
    jx, tx = _inputs(7, 2, 256, 256, 4, 2, 64, "float32")
    _check(jx, tx, "float32", causal=True, window=window)


def test_flash_attention_noncausal():
    jx, tx = _inputs(9, 1, 128, 96, 2, 2, 64, "float32")
    _check(jx, tx, "float32", causal=False)


def test_flash_attention_noncausal_ragged_follows_the_plain_version():
    """Sk = 200 is not a multiple of the reference's block: its wrapper
    pads the keys and its kernel masks on the padded length, so the zero
    keys enter the softmax (a quirk of the reference, ROADMAP queue 3).
    The port masks on the true length and equals `attention_ref`."""
    jx, tx = _inputs(11, 1, 128, 200, 2, 2, 64, "float32")
    want = fa_ref.attention_ref(*jx, causal=False)
    got = pt_ops.flash_attention(*tx, causal=False)
    assert _err(_np(got), want) < 2e-5
    assert _err(fa_ops.flash_attention(*jx, causal=False), want) > 1e-2


def test_flash_attention_rejects_mixed_devices():
    _, (q, k, v) = _inputs(0, 1, 8, 8, 2, 1, 16, "float32")
    with pytest.raises(ValueError):
        pt_ops.flash_attention(q, k.to("meta"), v)


@pytest.mark.parametrize("dtype,hd,kernel", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 256, "wgmma"), (torch.bfloat16, 16, "fma"),
    (torch.bfloat16, 80, "fma"), (torch.float32, 16, "fma"),
    (torch.float32, 64, "fma"), (torch.float32, 80, "fma"),
    (torch.float32, 128, "fma"), (torch.float32, 256, "fma"),
    (torch.float32, 24, "fma"), (torch.bfloat16, 32, "wgmma"),
    (torch.bfloat16, 96, "wgmma"), (torch.float32, 96, "fma"),
    (torch.bfloat16, 112, "wgmma"), (torch.float32, 112, "fma"),
    (torch.bfloat16, 320, "head_dim"), (torch.float32, 257, "head_dim"),
    (torch.bfloat16, 0, "head_dim"),
    (torch.float16, 128, "float32"), (torch.float64, 64, "float32"),
])
def test_flash_attention_dispatch_rule(dtype, hd, kernel):
    """The static (dtype, head_dim) rule that picks a CUDA call's kernel:
    fp32, and bf16 at 16 and 80, on the FMA kernel; every other bf16 head
    dim on the tensor-core kernel (those it is not built for, such as
    phi-3-vision's 96, zero-padded); head dims above 256 and other dtypes
    raise (the value names the message)."""
    if kernel in ("wgmma", "fma"):
        assert pt_ops.kernel_for(dtype, hd) == kernel
    else:
        with pytest.raises(ValueError, match=kernel):
            pt_ops.kernel_for(dtype, hd)


@pytest.mark.parametrize("dtype,hd,padded", [
    ("bfloat16", 96, 128), ("float32", 96, 128), ("bfloat16", 112, 128),
    ("float32", 112, 128), ("float32", 24, 64), ("bfloat16", 32, 64)])
@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=False),
                                dict(causal=True, window=48)])
def test_flash_attention_padded_head_dim_is_exact(dtype, hd, padded, kw):
    """A head dim the chosen kernel is not built for runs zero-padded to
    its next one with the true 1/sqrt(hd) as the scale (what the CUDA path
    launches): through `attention_ref` that equals the unpadded
    computation, the reference's plain version and its Pallas kernel in
    interpret mode (which pads to 128 and rescales q), at the usual
    bars."""
    jx, tx = _inputs(hd + len(kw), 2, 96, 96, 4, 2, hd, dtype)
    tol = DTYPES[dtype][2]
    kernel = pt_ops.kernel_for(tx[0].dtype, hd)
    assert pt_ops.kernel_head_dim(kernel, hd) == padded
    qp, kp, vp = pt_ops.padded_operands(*tx, kernel)
    assert qp.shape[-1] == kp.shape[-1] == vp.shape[-1] == padded
    got = pt_ref.attention_ref(qp, kp, vp, scale=hd ** -0.5, **kw)[..., :hd]
    assert _err(_np(got), _np(pt_ref.attention_ref(*tx, **kw))) < tol
    assert _err(_np(got), fa_ref.attention_ref(*jx, **kw)) < tol
    assert _err(_np(got), fa_ops.flash_attention(*jx, **kw)) < tol


def _load_tool(name):
    path = Path(__file__).resolve().parents[1] / "tools" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_ABLATION = _load_tool("flash_ablation")


@pytest.mark.parametrize("variant", sorted(_ABLATION.VARIANTS))
def test_flash_ablation_variant_matches_kernel_source(variant):
    """``tools/flash_ablation.py`` edits lines of the tensor-core kernel's
    source by their exact text: each variant's text is there once, and
    the variant's source differs from the kernel's only by its edit."""
    source = pt_ops.SOURCES[1].read_text()
    old, new = _ABLATION.VARIANTS[variant]
    assert source.count(old) == 1
    assert _ABLATION.variant_sources(source)[variant] == \
        source.replace(old, new) != source
