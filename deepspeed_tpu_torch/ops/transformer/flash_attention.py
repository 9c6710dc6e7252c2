"""Flash-attention forward — kernel K1 and its plain version.

Port of ``deepspeed_tpu/ops/transformer/flash_attention.py`` (forward
only; the backward kernels belong to the training slice).  The CUDA
kernel (``ops/csrc/flash_attention.cu``) replaces the Pallas ``_fwd`` /
``_fwd_kernel``: it reads q/k/v in the model's ``[B, S, H, D]`` layout
through strides (no transpose), runs the online softmax in fp32, skips k
tiles past its q tile's causal limit, maps GQA heads as ``kv = h*KVH//H``
and writes O in the input dtype plus the per-row LSE in fp32.

:func:`flash_attention` launches the kernel for CUDA tensors and runs
:func:`flash_attention_plain` only for CPU tensors; it never falls back.
"""

import math

import torch

from deepspeed_tpu_torch.ops import op_builder


def _pow2(scale):
    return scale > 0 and math.log2(scale).is_integer()


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
        off = torch.zeros(B, dtype=torch.long, device=q.device) \
            if q_offsets is None else q_offsets.to(q.device).long()
        qpos = off[:, None] + torch.arange(S, device=q.device)[None]   # [B, S]
        live = torch.arange(Sk, device=q.device)[None, None] <= qpos[..., None]
        s = s.masked_fill(~live[:, None], -1e30)
        p = torch.softmax(s, dim=-1) * live[:, None]
    else:
        p = torch.softmax(s, dim=-1)
    l = p.sum(-1)
    out = torch.einsum("bhst,bthd->bshd", p, vf)
    lse = torch.where(l > 0, torch.logsumexp(s, dim=-1),
                      torch.full_like(l, -1e30))
    return out.to(q.dtype), lse


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


def launch_attention_kernel(q, k, v, causal, scale, q_offsets, with_lse):
    """One launch of the shared K1/K3 kernel on CUDA tensors (q
    [B, S, H, D], k/v [B, Sk, KVH, D], any strides with a unit stride on
    D).  Returns (out, lse or None)."""
    B, S, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    if H % KVH:
        raise ValueError(f"num_heads {H} is not a multiple of kv heads {KVH}")
    if D not in (64, 128):
        raise ValueError(f"CUDA attention kernels take head_dim 64 or 128, "
                         f"got {D}")
    _check_cuda("attention kernel", q, k, v)
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


def flash_attention(q, k, v, causal=True, scale=None, return_lse=False):
    """Flash attention on [B, S, H, D] tensors (model-native layout);
    ``k``/``v`` may have fewer heads (GQA).  Returns [B, S, H, D], and the
    fp32 LSE [B, H, S] with ``return_lse``."""
    D = q.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    # a power-of-two scale (D = 64 -> 0.125) is folded into q outside the
    # kernel, exactly in q's dtype, as the JAX wrapper does; other scales
    # multiply the fp32 scores in the kernel
    if _pow2(scale):
        q = q * torch.tensor(scale, dtype=q.dtype)
        kscale = 1.0
    else:
        kscale = float(scale)
    if q.is_cuda:
        out, lse = launch_attention_kernel(q, k, v, causal, kscale, None,
                                           return_lse)
        flash_attention.launches += 1
    else:
        out, lse = flash_attention_plain(q, k, v, causal=causal, scale=kscale)
    return (out, lse) if return_lse else out


flash_attention.launches = 0
