"""Flash attention — kernels K1 (forward), K4 (dQ) and K5 (dK/dV) and
their plain versions.

Port of ``deepspeed_tpu/ops/transformer/flash_attention.py``.  The CUDA
forward (``ops/csrc/flash_attention.cu``) replaces the Pallas ``_fwd`` /
``_fwd_kernel``: it reads q/k/v in the model's ``[B, S, H, D]`` layout
through strides (no transpose), runs the online softmax in fp32, skips k
tiles past its q tile's causal limit, maps GQA heads as ``kv = h*KVH//H``
and writes O in the input dtype plus the per-row LSE in fp32.  For bf16 /
fp16 inputs both its products run on the tensor cores (wgmma) over tiles
that TMA loads, and P is rounded to the input dtype before P·V, as JAX
rounds it; fp32 inputs take fp32 FMAs.  The two
backward kernels (``ops/csrc/flash_attention_bwd.cu``) replace
``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``: for bf16 / fp16 inputs they
run every product on the tensor cores (wgmma) over tiles that TMA loads,
for fp32 inputs fp32 FMAs; :class:`_FlashAttention` is the port of the
JAX ``custom_vjp`` around them.

Each wrapper launches its kernel for CUDA tensors and runs the plain
version only for CPU tensors; it never falls back.  K1's forward is the
call site ``FORWARD_OP``, which a remat policy names to keep K1's output
and LSE (``utils/remat.py``).
"""

import math

import torch

from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops.op_builder import check_tma
from deepspeed_tpu_torch.utils.remat import kept


def _pow2(scale):
    return scale > 0 and math.log2(scale).is_integer()


def _causal_live(B, S, Sk, q_offsets, device):
    """[B, S, Sk] bool: query row i of batch row b (at position
    ``q_offsets[b] + i``) sees keys ``pos <= q_offsets[b] + i``."""
    off = torch.zeros(B, dtype=torch.long, device=device) \
        if q_offsets is None else q_offsets.to(device).long()
    qpos = off[:, None] + torch.arange(S, device=device)[None]       # [B, S]
    return torch.arange(Sk, device=device)[None, None] <= qpos[..., None]


def flash_attention_plain(q, k, v, causal=True, scale=None, q_offsets=None):
    """Dense fp32 attention with the same mask as the kernel: query row i
    of batch row b sits at position ``q_offsets[b] + i`` (0 when None) and
    sees keys ``pos <= q_offsets[b] + i`` when causal.  q: [B, S, H, D],
    k/v: [B, Sk, KVH, D].  Returns (out [B, S, H, D] in q's dtype,
    lse [B, H, S] fp32)."""
    B, S, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    kf = k.float().repeat_interleave(H // KVH, dim=2)
    vf = v.float().repeat_interleave(H // KVH, dim=2)
    s = torch.einsum("bshd,bthd->bhst", q.float(), kf) * scale
    if causal:
        live = _causal_live(B, S, Sk, q_offsets, q.device)
        s = s.masked_fill(~live[:, None], -1e30)
        p = torch.softmax(s, dim=-1) * live[:, None]
    else:
        p = torch.softmax(s, dim=-1)
    l = p.sum(-1)
    out = torch.einsum("bhst,bthd->bshd", p, vf)
    lse = torch.where(l > 0, torch.logsumexp(s, dim=-1),
                      torch.full_like(l, -1e30))
    return out.to(q.dtype), lse


def _delta(out, dout):
    """rowsum(dO * O) in fp32, [B, H, S] contiguous (JAX computes it
    outside its kernels too)."""
    return (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd_plain(q, k, v, out, lse, dout, causal=True,
                              scale=None):
    """The gradient the backward kernels compute, densely in fp32 from the
    saved residuals (q as the kernel saw it, k, v, out, lse [B, H, S]) and
    dO — not autograd through the plain forward.  P = exp(scale*q.k - lse)
    (0 where masked), dS = P * (dO.v - delta) * scale; dq = dS.k,
    dk = dS^T.q, dv = P^T.dO, each GQA group summed.  For 16-bit inputs P
    and dS are rounded to the input dtype before the second products, and
    each query head's dk / dv before its group's sum, as the JAX kernels
    (``ds.astype(k.dtype)``, ``p.astype(do.dtype)``, a 16-bit dk / dv per
    head) and K4 / K5 round them; fp32 keeps them in fp32.  Returns
    (dq, dk, dv) in the inputs' dtypes."""
    B, S, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    rep = H // KVH
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    lowp = q.dtype in (torch.bfloat16, torch.float16)
    qf, dof = q.float(), dout.float()
    kf = k.float().repeat_interleave(rep, dim=2)
    vf = v.float().repeat_interleave(rep, dim=2)
    s = torch.einsum("bshd,bthd->bhst", qf, kf) * scale
    p = torch.exp(s - lse.float()[..., None])
    if causal:
        live = _causal_live(B, S, Sk, None, q.device)
        p = torch.where(live[:, None], p, torch.zeros((), device=q.device))
    dp = torch.einsum("bshd,bthd->bhst", dof, vf)
    ds = p * (dp - _delta(out, dout)[..., None]) * scale
    if lowp:
        ds = ds.to(q.dtype).float()
        p = p.to(dout.dtype).float()
    dq = torch.einsum("bhst,bthd->bshd", ds, kf)
    dk = torch.einsum("bhst,bshd->bthd", ds, qf)
    dv = torch.einsum("bhst,bshd->bthd", p, dof)
    if lowp:
        dk, dv = dk.to(q.dtype).float(), dv.to(q.dtype).float()
    dk = dk.view(B, Sk, KVH, rep, D).sum(3)
    dv = dv.view(B, Sk, KVH, rep, D).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_cuda(name, *tensors):
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype != tensors[0].dtype:
            raise TypeError(f"{name}: mixed dtypes {t.dtype} / "
                            f"{tensors[0].dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the last dim must be contiguous")


def _check_shapes(q, k):
    H, D = q.shape[2], q.shape[3]
    KVH = k.shape[2]
    if H % KVH:
        raise ValueError(f"num_heads {H} is not a multiple of kv heads {KVH}")
    if D not in (64, 128):
        raise ValueError(f"CUDA attention kernels take head_dim 64 or 128, "
                         f"got {D}")


def launch_attention_kernel(q, k, v, causal, scale, q_offsets, with_lse):
    """One launch of the shared K1/K3 kernel on CUDA tensors (q
    [B, S, H, D], k/v [B, Sk, KVH, D], any strides with a unit stride on
    D).  Returns (out, lse or None)."""
    B, S, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    _check_shapes(q, k)
    _check_cuda("attention kernel", q, k, v)
    if q.dtype != torch.float32:
        if Sk == 0:
            raise ValueError("flash attention forward: no keys")
        for name, t in (("q", q), ("k", k), ("v", v)):
            check_tma("flash attention forward", name, t)
    out = torch.empty(B, S, H, D, dtype=q.dtype, device=q.device)
    lse = torch.empty(B, H, S, dtype=torch.float32, device=q.device) \
        if with_lse else None
    if q_offsets is not None:
        q_offsets = q_offsets.to(device=q.device, dtype=torch.int32)
        q_offsets = q_offsets.contiguous()
    lib = op_builder.FLASH.load()
    err = lib.dstt_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        None if q_offsets is None else q_offsets.data_ptr(),
        op_builder.dtype_code(q.dtype), B, S, H, KVH, D, Sk,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        int(bool(causal)), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    op_builder.check(err, "flash attention kernel")
    return out, lse


def _bwd_args(q, k, v, dout, lse, delta):
    _check_shapes(q, k)
    _check_cuda("flash attention backward", q, k, v, dout)
    for t in (lse, delta):
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != q.device:
            raise ValueError("lse / delta must be contiguous fp32 on q's "
                             "device")
    if q.dtype != torch.float32:
        if k.shape[1] == 0:
            raise ValueError("flash attention backward: no keys")
        for name, t in (("q", q), ("k", k), ("v", v), ("dout", dout)):
            check_tma("flash attention backward", name, t)
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr())


def flash_attention_dq(q, k, v, dout, lse, delta, causal, scale):
    """K4: dq [B, S, H, D] in q's dtype, from CUDA q/dout [B, S, H, D],
    k/v [B, Sk, KVH, D] (strided, unit stride on D) and fp32 lse / delta
    [B, H, S]."""
    ptrs = _bwd_args(q, k, v, dout, lse, delta)
    B, S, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    dq = torch.empty(B, S, H, D, dtype=q.dtype, device=q.device)
    err = op_builder.FLASH_BWD.load().dstt_flash_attention_bwd_dq(
        *ptrs, dq.data_ptr(), op_builder.dtype_code(q.dtype), B, S, H, KVH,
        D, Sk, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *dout.stride()[:3], *dq.stride()[:3], int(bool(causal)),
        float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    op_builder.check(err, "flash attention dq kernel")
    flash_attention_dq.launches += 1
    return dq


def flash_attention_dkv(q, k, v, dout, lse, delta, causal, scale):
    """K5: (dk, dv), each [B, Sk, H, D] per QUERY head in q's dtype; the
    caller sums each GQA group."""
    ptrs = _bwd_args(q, k, v, dout, lse, delta)
    B, S, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    dk = torch.empty(B, Sk, H, D, dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    err = op_builder.FLASH_BWD.load().dstt_flash_attention_bwd_dkv(
        *ptrs, dk.data_ptr(), dv.data_ptr(), op_builder.dtype_code(q.dtype),
        B, S, H, KVH, D, Sk, *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], *dout.stride()[:3], *dk.stride()[:3],
        int(bool(causal)), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    op_builder.check(err, "flash attention dk/dv kernel")
    flash_attention_dkv.launches += 1
    return dk, dv


op_builder.launch_counters(flash_attention_dq, "launches")
op_builder.launch_counters(flash_attention_dkv, "launches")


def flash_attention_bwd(q, k, v, out, lse, dout, causal=True, scale=None):
    """Backward of the kernel forward: (dq, dk, dv) for the saved q (as
    the kernel saw it), k, v, out, lse and the incoming dO.  CUDA tensors
    launch K4 and K5 (dO is read through its strides and made contiguous
    only when its last dim is strided); CPU tensors take
    :func:`flash_attention_bwd_plain`."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if not q.is_cuda:
        return flash_attention_bwd_plain(q, k, v, out, lse, dout, causal,
                                         scale)
    if dout.stride(-1) != 1:
        dout = dout.contiguous()
    delta = _delta(out, dout)
    dq = flash_attention_dq(q, k, v, dout, lse, delta, causal, scale)
    dk, dv = flash_attention_dkv(q, k, v, dout, lse, delta, causal, scale)
    B, Sk, KVH, D = k.shape
    if KVH != q.shape[2]:        # sum each query-head group, no atomics
        rep = q.shape[2] // KVH
        dk = dk.view(B, Sk, KVH, rep, D).float().sum(3)
        dv = dv.view(B, Sk, KVH, rep, D).float().sum(3)
    return dq, dk.to(k.dtype), dv.to(v.dtype)


# the name of K1's forward call site: a remat policy that keeps it keeps
# K1's output and LSE, as JAX's names the kernel's flash_out / flash_lse,
# and its recompute launches K1 no more
FORWARD_OP = "flash_attention_fwd"


def _launch_forward(q, k, v, causal, kscale, with_lse):
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, causal=causal, scale=kscale)
    out = launch_attention_kernel(q, k, v, causal, kscale, None, with_lse)
    flash_attention.launches += 1
    return out


def _forward(q, k, v, causal, kscale, with_lse):
    """One K1 launch for CUDA tensors (counted), the plain forward for CPU
    tensors; in the recompute of a remat region whose policy keeps
    ``FORWARD_OP``, the forward's output and LSE instead.  Returns (out,
    lse or None on CUDA without ``with_lse``)."""
    return kept(FORWARD_OP, _launch_forward, q, k, v, causal, kscale,
                with_lse)


class _FlashAttention(torch.autograd.Function):
    """The JAX ``_flash_bhsd`` custom_vjp: the forward saves q, k, v, out
    and the LSE; the backward runs K4 and K5 (or the plain backward on the
    CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, kscale):
        out, lse = _forward(q, k, v, causal, kscale, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.kscale = causal, kscale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, ctx.causal,
                                         ctx.kscale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal=True, scale=None, return_lse=False):
    """Flash attention on [B, S, H, D] tensors (model-native layout);
    ``k``/``v`` may have fewer heads (GQA).  Returns [B, S, H, D], and the
    fp32 LSE [B, H, S] with ``return_lse``.  Differentiable: when grad mode
    is on and an input requires a gradient, the forward also saves the LSE
    and the backward runs K4 / K5; otherwise it is one K1 launch."""
    D = q.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    # a power-of-two scale (D = 64 -> 0.125) is folded into q outside the
    # kernel, exactly in q's dtype, as the JAX wrapper does (autograd
    # carries dq's scale through this multiply); other scales multiply the
    # fp32 scores (and dS) in the kernels
    if _pow2(scale):
        q = q * torch.tensor(scale, dtype=q.dtype)
        kscale = 1.0
    else:
        kscale = float(scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        out, lse = _FlashAttention.apply(q, k, v, bool(causal), kscale)
    else:
        out, lse = _forward(q, k, v, causal, kscale, return_lse)
    return (out, lse) if return_lse else out


op_builder.launch_counters(flash_attention, "launches")
