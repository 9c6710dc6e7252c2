"""HF-architecture injection policies — base class and weight transforms
(port of ``deepspeed_tpu/module_inject/policy.py``).

A policy maps an HF torch model onto the port's ``Transformer``:

* ``build_config(hf_config)`` → the port's ``TransformerConfig``
  capturing the architecture (activation, norm type, rope layout, residual
  topology);
* ``convert(state_dict, cfg)`` → the flat ``{flax path: np.ndarray}``
  dict the JAX package's policy produces, key for key (transpose,
  fused-qkv split, head reshape), which ``models.transformer.
  params_from_flax`` loads: one weight format shared by both packages.
"""

import numpy as np

from deepspeed_tpu_torch.models.transformer import TransformerConfig

# HF activation-string → TransformerConfig.activation.  HF "gelu" is the
# exact erf form; "gelu_new"/tanh variants map to the tanh approximation.
ACT_MAP = {
    "relu": "relu",
    "gelu": "gelu_exact",
    "gelu_new": "gelu",
    "gelu_fast": "gelu",
    "gelu_pytorch_tanh": "gelu",
    "silu": "silu",
    "swish": "silu",
    "quick_gelu": "quick_gelu",
}


def _np(t):
    """torch tensor (or array) → float32 numpy (host)."""
    if hasattr(t, "detach"):
        t = t.detach().cpu().float().numpy()
    return np.asarray(t, dtype=np.float32)


def linear_kernel(w):
    """torch Linear weight [out, in] → flax kernel [in, out]."""
    return np.ascontiguousarray(_np(w).T)


def qkv_kernel(w, heads, head_dim):
    """torch [H*D, in] → flax DenseGeneral kernel [in, H, D]."""
    return np.ascontiguousarray(_np(w).T.reshape(-1, heads, head_dim))


def qkv_bias(b, heads, head_dim):
    return _np(b).reshape(heads, head_dim)


def o_kernel(w, heads, head_dim):
    """torch [hidden, H*D] → flax DenseGeneral kernel [H, D, hidden]."""
    return np.ascontiguousarray(_np(w).T.reshape(heads, head_dim, -1))


# -- inverse transforms (export: flax params → HF state dict) ----------- #
def inv_linear_kernel(k):
    """flax kernel [in, out] → torch Linear weight [out, in]."""
    return np.ascontiguousarray(np.asarray(k).T)


def inv_qkv_kernel(k):
    """flax DenseGeneral kernel [in, H, D] → torch [H*D, in]."""
    a = np.asarray(k)
    return np.ascontiguousarray(a.reshape(a.shape[0], -1).T)


def inv_qkv_bias(b):
    """flax bias [H, D] → torch [H*D]."""
    return np.ascontiguousarray(np.asarray(b).reshape(-1))


def inv_o_kernel(k):
    """flax DenseGeneral kernel [H, D, hidden] → torch [hidden, H*D]."""
    a = np.asarray(k)
    return np.ascontiguousarray(a.reshape(-1, a.shape[-1]).T)


def split_fused_qkv_headwise(w, heads, head_dim, bias=None):
    """Split a head-interleaved fused QKV (neox/bloom layout: output rows
    arranged [H, 3, D]) into per-projection flax kernels.

    Returns dict with q/k/v kernels [in, H, D] (+ biases [H, D])."""
    wn = _np(w).reshape(heads, 3, head_dim, -1)       # [H, 3, D, in]
    out = {}
    for j, name in enumerate(("q_proj", "k_proj", "v_proj")):
        out[f"attn/{name}/kernel"] = np.ascontiguousarray(
            wn[:, j].transpose(2, 0, 1))              # [in, H, D]
        if bias is not None:
            bn = _np(bias).reshape(heads, 3, head_dim)
            out[f"attn/{name}/bias"] = np.ascontiguousarray(bn[:, j])
    return out


def split_fused_qkv_columns(w_in_out, heads, head_dim, bias=None):
    """Split a column-fused QKV already in [in, 3*H*D] layout (GPT2 Conv1D)
    into per-projection flax kernels [in, H, D]."""
    h = heads * head_dim
    wn = np.asarray(w_in_out)
    out = {}
    for j, name in enumerate(("q_proj", "k_proj", "v_proj")):
        out[f"attn/{name}/kernel"] = np.ascontiguousarray(
            wn[:, j * h:(j + 1) * h].reshape(-1, heads, head_dim))
        if bias is not None:
            bn = np.asarray(bias)
            out[f"attn/{name}/bias"] = np.ascontiguousarray(
                bn[j * h:(j + 1) * h].reshape(heads, head_dim))
    return out


class HFPolicy:
    """Base policy.  Subclasses set ``model_types`` and implement
    ``build_config`` / ``layer_params`` / ``top_params``."""

    model_types = ()

    @classmethod
    def match(cls, hf_config):
        return getattr(hf_config, "model_type", None) in cls.model_types

    # -- architecture ---------------------------------------------------- #
    def build_config(self, hf_config, **overrides) -> TransformerConfig:
        raise NotImplementedError

    def build_model(self, cfg, device="cpu"):
        """The port module the converted weights load into (the decoder
        families share ``Transformer``)."""
        from deepspeed_tpu_torch.models.transformer import Transformer
        return Transformer(cfg, device=device)

    # -- weights --------------------------------------------------------- #
    def layer_params(self, sd, i, cfg) -> dict:
        """{relative-path: array} for layer i (keys like
        'attn/q_proj/kernel', 'input_norm/scale', 'mlp/up_proj/bias')."""
        raise NotImplementedError

    def top_params(self, sd, cfg) -> dict:
        """{path: array} for embeddings / final norm / lm head."""
        raise NotImplementedError

    def export_convert(self, flat, cfg) -> dict:
        """Inverse of :meth:`convert`: flat flax params {path: array} →
        HF-named state dict {hf_key: np.ndarray} (reference
        ``save_16bit_model``'s output is consumable by HF loaders).
        Policies implement this per family."""
        raise NotImplementedError(
            f"{type(self).__name__} has no HF export mapping yet; call "
            "save_16bit_model without hf_policy for flax-named keys")

    def convert(self, sd, cfg):
        """Full flat param dict {path: np.ndarray}: scanned layers stack on a
        leading layer axis ('layers/...'); with ``scan_layers=False`` each
        layer keeps its own 'layers_{i}/...' paths."""
        flat = dict(self.top_params(sd, cfg))
        per_layer = [self.layer_params(sd, i, cfg)
                     for i in range(cfg.num_layers)]
        if not getattr(cfg, "scan_layers", True):
            for i, lp in enumerate(per_layer):
                for key, val in lp.items():
                    flat[f"layers_{i}/{key}"] = val
            return flat
        keys = set(per_layer[0].keys())
        for i, lp in enumerate(per_layer):
            if set(lp.keys()) != keys:
                raise ValueError(f"layer {i} parameter set differs: "
                                 f"{set(lp.keys()) ^ keys}")
        for key in keys:
            flat[f"layers/{key}"] = np.stack([lp[key] for lp in per_layer])
        return flat

    # -- shared pieces --------------------------------------------------- #
    @staticmethod
    def norm(sd, prefix, out_name, rms=False):
        out = {f"{out_name}/scale": _np(sd[f"{prefix}.weight"])}
        if not rms and f"{prefix}.bias" in sd:
            out[f"{out_name}/bias"] = _np(sd[f"{prefix}.bias"])
        return out

    @staticmethod
    def attn_separate(sd, prefix, cfg, src_names=None, out_name="out_proj"):
        """Separate q/k/v/out projections.  ``src_names`` maps our
        q_proj/k_proj/v_proj onto the HF names (default: same names)."""
        H, KVH, D = cfg.num_heads, cfg.kv_heads, cfg.head_dim
        src_names = src_names or {}
        out = {}
        for std, heads in (("q_proj", H), ("k_proj", KVH), ("v_proj", KVH)):
            src = src_names.get(std, std)
            out[f"attn/{std}/kernel"] = \
                qkv_kernel(sd[f"{prefix}.{src}.weight"], heads, D)
            if f"{prefix}.{src}.bias" in sd:
                out[f"attn/{std}/bias"] = \
                    qkv_bias(sd[f"{prefix}.{src}.bias"], heads, D)
        out["attn/o_proj/kernel"] = o_kernel(sd[f"{prefix}.{out_name}.weight"],
                                             H, D)
        if f"{prefix}.{out_name}.bias" in sd:
            out["attn/o_proj/bias"] = _np(sd[f"{prefix}.{out_name}.bias"])
        return out
