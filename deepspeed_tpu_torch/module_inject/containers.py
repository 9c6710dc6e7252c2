"""Per-architecture injection policies (port of
``deepspeed_tpu/module_inject/containers.py``): one policy class per HF
decoder family whose every knob the port's ``Transformer`` has — OPT
(with opt-350m's post-LN and ``embed_proj_dim`` layout, and an HF-named
export), GPT-2, Llama / Mistral, GPT-Neo and Megatron-LM GPT.  The JAX
package's other
families raise ``NotImplementedError`` naming what the port still lacks
(:data:`UNPORTED_FAMILIES`, ROADMAP.md).
"""

import numpy as np

from deepspeed_tpu_torch.models.transformer import TransformerConfig
from deepspeed_tpu_torch.module_inject.policy import (
    ACT_MAP, HFPolicy, _np, inv_linear_kernel, inv_o_kernel, inv_qkv_bias,
    inv_qkv_kernel, linear_kernel, o_kernel, split_fused_qkv_columns,
    split_fused_qkv_headwise)


class OPTPolicy(HFPolicy):
    """facebook/opt-* (reference ``containers/opt.py``)."""

    model_types = ("opt",)

    def build_config(self, hf, **over):
        proj = getattr(hf, "word_embed_proj_dim", hf.hidden_size)
        base = dict(
            vocab_size=hf.vocab_size,
            hidden_size=hf.hidden_size,
            num_layers=hf.num_hidden_layers,
            num_heads=hf.num_attention_heads,
            ffn_hidden_size=hf.ffn_dim,
            max_seq_len=hf.max_position_embeddings,
            activation=ACT_MAP[hf.activation_function],
            position_embedding="learned",
            tie_word_embeddings=hf.tie_word_embeddings,
            # opt-350m: embeddings in a 512-dim space with project_in/out,
            # post-LN blocks, no final norm
            embed_proj_dim=proj if proj != hf.hidden_size else None,
            pre_layer_norm=getattr(hf, "do_layer_norm_before", True),
        )
        base.update(over)
        return TransformerConfig(**base)

    def top_params(self, sd, cfg):
        out = {"embed_tokens/embedding": _np(sd["model.decoder.embed_tokens.weight"]),
               # OPTLearnedPositionalEmbedding carries a +2 offset; drop the
               # two offset rows so plain arange positions index correctly.
               "embed_positions/embedding":
                   _np(sd["model.decoder.embed_positions.weight"])[2:]}
        if cfg.pre_layer_norm:
            out.update(self.norm(sd, "model.decoder.final_layer_norm",
                                 "final_norm"))
        if cfg.embed_proj_dim is not None:
            out["project_in/kernel"] = linear_kernel(
                sd["model.decoder.project_in.weight"])
            out["project_out/kernel"] = linear_kernel(
                sd["model.decoder.project_out.weight"])
        if not cfg.tie_word_embeddings:
            out["lm_head/kernel"] = linear_kernel(sd["lm_head.weight"])
        return out

    def layer_params(self, sd, i, cfg):
        p = f"model.decoder.layers.{i}"
        out = self.attn_separate(sd, f"{p}.self_attn", cfg)
        out.update(self.norm(sd, f"{p}.self_attn_layer_norm", "input_norm"))
        # OPT's per-layer "final_layer_norm" is the pre-MLP norm
        out.update(self.norm(sd, f"{p}.final_layer_norm", "post_attn_norm"))
        out["mlp/up_proj/kernel"] = linear_kernel(sd[f"{p}.fc1.weight"])
        out["mlp/up_proj/bias"] = _np(sd[f"{p}.fc1.bias"])
        out["mlp/down_proj/kernel"] = linear_kernel(sd[f"{p}.fc2.weight"])
        out["mlp/down_proj/bias"] = _np(sd[f"{p}.fc2.bias"])
        return out

    def export_convert(self, flat, cfg):
        """Inverse of convert: flax flat params → HF OPT state dict (the
        key table ``layer_params``/``top_params`` read from, inverted —
        reference ``engine.py:3297`` save_16bit_model emits HF-loadable
        names)."""
        sd = {"model.decoder.embed_tokens.weight":
              np.asarray(flat["embed_tokens/embedding"])}
        pos = np.asarray(flat["embed_positions/embedding"])
        # restore OPTLearnedPositionalEmbedding's +2 offset rows (HF indexes
        # past them via the offset; their values are never read)
        sd["model.decoder.embed_positions.weight"] = np.concatenate(
            [np.zeros((2, pos.shape[1]), pos.dtype), pos])
        if cfg.pre_layer_norm:
            sd["model.decoder.final_layer_norm.weight"] = \
                np.asarray(flat["final_norm/scale"])
            sd["model.decoder.final_layer_norm.bias"] = \
                np.asarray(flat["final_norm/bias"])
        if cfg.embed_proj_dim is not None:
            sd["model.decoder.project_in.weight"] = \
                inv_linear_kernel(flat["project_in/kernel"])
            sd["model.decoder.project_out.weight"] = \
                inv_linear_kernel(flat["project_out/kernel"])
        if not cfg.tie_word_embeddings and "lm_head/kernel" in flat:
            sd["lm_head.weight"] = inv_linear_kernel(flat["lm_head/kernel"])

        def src(i, key):
            if getattr(cfg, "scan_layers", True):
                return np.asarray(flat[f"layers/{key}"])[i]
            return np.asarray(flat[f"layers_{i}/{key}"])

        def has(i, key):
            return (f"layers/{key}" in flat) if getattr(cfg, "scan_layers",
                                                        True) \
                else (f"layers_{i}/{key}" in flat)

        for i in range(cfg.num_layers):
            p = f"model.decoder.layers.{i}"
            for std in ("q_proj", "k_proj", "v_proj"):
                sd[f"{p}.self_attn.{std}.weight"] = \
                    inv_qkv_kernel(src(i, f"attn/{std}/kernel"))
                if has(i, f"attn/{std}/bias"):
                    sd[f"{p}.self_attn.{std}.bias"] = \
                        inv_qkv_bias(src(i, f"attn/{std}/bias"))
            sd[f"{p}.self_attn.out_proj.weight"] = \
                inv_o_kernel(src(i, "attn/o_proj/kernel"))
            if has(i, "attn/o_proj/bias"):
                sd[f"{p}.self_attn.out_proj.bias"] = src(i, "attn/o_proj/bias")
            sd[f"{p}.self_attn_layer_norm.weight"] = src(i, "input_norm/scale")
            sd[f"{p}.self_attn_layer_norm.bias"] = src(i, "input_norm/bias")
            sd[f"{p}.final_layer_norm.weight"] = src(i, "post_attn_norm/scale")
            sd[f"{p}.final_layer_norm.bias"] = src(i, "post_attn_norm/bias")
            sd[f"{p}.fc1.weight"] = inv_linear_kernel(src(i, "mlp/up_proj/kernel"))
            sd[f"{p}.fc1.bias"] = src(i, "mlp/up_proj/bias")
            sd[f"{p}.fc2.weight"] = inv_linear_kernel(src(i, "mlp/down_proj/kernel"))
            sd[f"{p}.fc2.bias"] = src(i, "mlp/down_proj/bias")
        return sd



class GPT2Policy(HFPolicy):
    """gpt2* (reference ``containers/gpt2.py`` / megatron containers).
    GPT2 uses Conv1D ([in, out]) weights — no transpose needed."""

    model_types = ("gpt2",)

    def build_config(self, hf, **over):
        base = dict(
            vocab_size=hf.vocab_size,
            hidden_size=hf.n_embd,
            num_layers=hf.n_layer,
            num_heads=hf.n_head,
            ffn_hidden_size=(hf.n_inner or 4 * hf.n_embd),
            max_seq_len=hf.n_positions,
            activation=ACT_MAP[hf.activation_function],
            position_embedding="learned",
            tie_word_embeddings=True,
        )
        base.update(over)
        return TransformerConfig(**base)

    def top_params(self, sd, cfg):
        out = {"embed_tokens/embedding": _np(sd["transformer.wte.weight"]),
               "embed_positions/embedding": _np(sd["transformer.wpe.weight"])}
        out.update(self.norm(sd, "transformer.ln_f", "final_norm"))
        return out

    def layer_params(self, sd, i, cfg):
        p = f"transformer.h.{i}"
        H, D = cfg.num_heads, cfg.head_dim
        out = split_fused_qkv_columns(_np(sd[f"{p}.attn.c_attn.weight"]), H, D,
                                      bias=_np(sd[f"{p}.attn.c_attn.bias"]))
        # c_proj is Conv1D [in=H*D, out=h]: already [in, out]
        out["attn/o_proj/kernel"] = np.ascontiguousarray(
            _np(sd[f"{p}.attn.c_proj.weight"]).reshape(H, D, -1))
        out["attn/o_proj/bias"] = _np(sd[f"{p}.attn.c_proj.bias"])
        out.update(self.norm(sd, f"{p}.ln_1", "input_norm"))
        out.update(self.norm(sd, f"{p}.ln_2", "post_attn_norm"))
        out["mlp/up_proj/kernel"] = _np(sd[f"{p}.mlp.c_fc.weight"])
        out["mlp/up_proj/bias"] = _np(sd[f"{p}.mlp.c_fc.bias"])
        out["mlp/down_proj/kernel"] = _np(sd[f"{p}.mlp.c_proj.weight"])
        out["mlp/down_proj/bias"] = _np(sd[f"{p}.mlp.c_proj.bias"])
        return out



class LlamaPolicy(HFPolicy):
    """llama/mistral family (reference ``containers/llama.py``)."""

    model_types = ("llama", "mistral")

    def build_config(self, hf, **over):
        base = dict(
            vocab_size=hf.vocab_size,
            hidden_size=hf.hidden_size,
            num_layers=hf.num_hidden_layers,
            num_heads=hf.num_attention_heads,
            num_kv_heads=getattr(hf, "num_key_value_heads",
                                 hf.num_attention_heads),
            ffn_hidden_size=hf.intermediate_size,
            max_seq_len=hf.max_position_embeddings,
            activation=ACT_MAP[hf.hidden_act],
            gated_mlp=True,
            position_embedding="rope",
            rope_theta=getattr(hf, "rope_theta", 10000.0),
            rms_norm=True,
            layernorm_epsilon=hf.rms_norm_eps,
            tie_word_embeddings=getattr(hf, "tie_word_embeddings", False),
        )
        base.update(over)
        return TransformerConfig(**base)

    def top_params(self, sd, cfg):
        out = {"embed_tokens/embedding": _np(sd["model.embed_tokens.weight"])}
        out.update(self.norm(sd, "model.norm", "final_norm", rms=True))
        if not cfg.tie_word_embeddings:
            out["lm_head/kernel"] = linear_kernel(sd["lm_head.weight"])
        return out

    def layer_params(self, sd, i, cfg):
        p = f"model.layers.{i}"
        out = self.attn_separate(sd, f"{p}.self_attn", cfg, out_name="o_proj")
        out.update(self.norm(sd, f"{p}.input_layernorm", "input_norm", rms=True))
        out.update(self.norm(sd, f"{p}.post_attention_layernorm",
                             "post_attn_norm", rms=True))
        for name in ("gate_proj", "up_proj", "down_proj"):
            out[f"mlp/{name}/kernel"] = linear_kernel(sd[f"{p}.mlp.{name}.weight"])
        return out



class GPTNeoPolicy(HFPolicy):
    """EleutherAI/gpt-neo (reference ``containers/gptneo.py``): alternating
    global/local (banded, window 256) attention layers, *unscaled* attention
    logits, biasless q/k/v with a biased out-projection, Linear (not Conv1D)
    MLP weights.  Per-layer attention patterns make the trunk heterogeneous,
    so layers are emitted unstacked (``scan_layers=False``)."""

    model_types = ("gpt_neo",)

    def build_config(self, hf, **over):
        over.pop("scan_layers", None)   # forced off: heterogeneous layers
        base = dict(
            vocab_size=hf.vocab_size,
            hidden_size=hf.hidden_size,
            num_layers=hf.num_layers,
            num_heads=hf.num_heads,
            ffn_hidden_size=(hf.intermediate_size or 4 * hf.hidden_size),
            max_seq_len=hf.max_position_embeddings,
            activation=ACT_MAP[hf.activation_function],
            position_embedding="learned",
            tie_word_embeddings=True,
            attention_bias=False,         # q/k/v carry no bias...
            attention_out_bias=True,      # ...but out_proj does
            attention_softmax_scale=1.0,  # gpt-neo skips 1/sqrt(D)
            attention_layers=tuple(hf.attention_layers),
            window_size=hf.window_size,
            layernorm_epsilon=hf.layer_norm_epsilon,
            scan_layers=False,
        )
        base.update(over)
        return TransformerConfig(**base)

    def top_params(self, sd, cfg):
        out = {"embed_tokens/embedding": _np(sd["transformer.wte.weight"]),
               "embed_positions/embedding": _np(sd["transformer.wpe.weight"])}
        out.update(self.norm(sd, "transformer.ln_f", "final_norm"))
        return out

    def layer_params(self, sd, i, cfg):
        p = f"transformer.h.{i}"
        out = self.attn_separate(sd, f"{p}.attn.attention", cfg)
        out.update(self.norm(sd, f"{p}.ln_1", "input_norm"))
        out.update(self.norm(sd, f"{p}.ln_2", "post_attn_norm"))
        out["mlp/up_proj/kernel"] = linear_kernel(sd[f"{p}.mlp.c_fc.weight"])
        out["mlp/up_proj/bias"] = _np(sd[f"{p}.mlp.c_fc.bias"])
        out["mlp/down_proj/kernel"] = linear_kernel(sd[f"{p}.mlp.c_proj.weight"])
        out["mlp/down_proj/bias"] = _np(sd[f"{p}.mlp.c_proj.bias"])
        return out



class MegatronGPTPolicy(HFPolicy):
    """Megatron-LM GPT checkpoints (reference ``containers/megatron_gpt.py``
    + ``replace_policy.py`` MegatronLayerPolicy): pre-LN GPT-2 architecture
    with fused query_key_value, dense_h_to_4h/dense_4h_to_h MLP naming, and
    two fused-QKV row layouts — Megatron v2 interleaves per head ([H, 3, D]),
    v1 chunks per projection ([3, H·D]).  Consumes a *merged* state dict (use
    ``runtime/state_dict_factory.py`` MegatronSDLoader to fold TP shards
    first); see ``replace_module.load_megatron_model`` for the end-to-end
    path."""

    model_types = ("megatron-gpt",)
    PREFIXES = ("model.language_model.", "language_model.", "module.", "")
    megatron_v2 = True

    @staticmethod
    def normalize(sd):
        """Strip megatron wrapper prefixes; unify encoder/transformer."""
        out = {}
        for k, v in sd.items():
            for p in MegatronGPTPolicy.PREFIXES:
                if p and k.startswith(p):
                    k = k[len(p):]
                    break
            k = k.replace("encoder.layers.", "transformer.layers.")
            out[k] = v
        return out

    def build_config(self, hf, **over):
        # hf here is a plain namespace carrying megatron args
        def get(n, d=None):
            return getattr(hf, n, d)
        base = dict(
            vocab_size=get("padded_vocab_size") or get("vocab_size"),
            hidden_size=get("hidden_size"),
            num_layers=get("num_layers"),
            num_heads=get("num_attention_heads") or get("num_heads"),
            ffn_hidden_size=get("ffn_hidden_size") or 4 * get("hidden_size"),
            max_seq_len=get("max_position_embeddings", 1024),
            activation="gelu",
            position_embedding="learned",
            tie_word_embeddings=True,
            layernorm_epsilon=get("layernorm_epsilon", 1e-5),
        )
        base.update(over)
        return TransformerConfig(**base)

    def top_params(self, sd, cfg):
        emb = "embedding.word_embeddings.weight"
        pos = "embedding.position_embeddings.weight"
        out = {"embed_tokens/embedding":
               _np(sd[emb] if emb in sd
                   else sd["word_embeddings.weight"])[:cfg.vocab_size],
               "embed_positions/embedding":
               _np(sd[pos] if pos in sd
                   else sd["position_embeddings.weight"])}
        out.update(self.norm(sd, "transformer.final_layernorm", "final_norm"))
        return out

    def layer_params(self, sd, i, cfg):
        p = f"transformer.layers.{i}"
        H, D = cfg.num_heads, cfg.head_dim
        w = sd[f"{p}.attention.query_key_value.weight"]
        b = sd.get(f"{p}.attention.query_key_value.bias")
        if self.megatron_v2:
            out = split_fused_qkv_headwise(w, H, D, bias=b)
        else:
            out = split_fused_qkv_columns(_np(w).T, H, D,
                                          bias=None if b is None else _np(b))
        out["attn/o_proj/kernel"] = o_kernel(
            sd[f"{p}.attention.dense.weight"], H, D)
        out["attn/o_proj/bias"] = _np(sd[f"{p}.attention.dense.bias"])
        out.update(self.norm(sd, f"{p}.input_layernorm", "input_norm"))
        out.update(self.norm(sd, f"{p}.post_attention_layernorm",
                             "post_attn_norm"))
        out["mlp/up_proj/kernel"] = linear_kernel(
            sd[f"{p}.mlp.dense_h_to_4h.weight"])
        out["mlp/up_proj/bias"] = _np(sd[f"{p}.mlp.dense_h_to_4h.bias"])
        out["mlp/down_proj/kernel"] = linear_kernel(
            sd[f"{p}.mlp.dense_4h_to_h.weight"])
        out["mlp/down_proj/bias"] = _np(sd[f"{p}.mlp.dense_4h_to_h.bias"])
        return out



ALL_POLICIES = [OPTPolicy, GPT2Policy, LlamaPolicy, GPTNeoPolicy,
                MegatronGPTPolicy]

# the JAX package's other families: model_type -> what the port lacks
UNPORTED_FAMILIES = {
    "bloom": "alibi positions and embedding_norm",
    "gpt_neox": "parallel_residual",
    "gptj": "parallel_residual with the shared attention / MLP norm",
    "bert": "the encoder models (models/bert.py)",
    "distilbert": "the encoder models (models/bert.py)",
    "clip_text_model": "the encoder models (models/bert.py)",
    "clip": "the encoder models (models/bert.py)",
    "megatron-gpt-moe": "MoE (mlp.deepspeed_moe experts)",
}
