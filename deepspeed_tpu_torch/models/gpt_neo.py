"""GPT-Neo model presets.

The JAX package has no GPT-Neo preset: it builds the shared
``TransformerConfig`` from an HF config in
``deepspeed_tpu/module_inject/containers.py`` ``GPTNeoPolicy.build_config``.
These presets type in the published ``EleutherAI/gpt-neo-*`` settings and
map them the same way: learned positions, gelu (HF ``gelu_new``, tanh),
pre-LN with epsilon 1e-5, a tied head, biasless q/k/v with a biased
out-projection, unscaled attention logits (``attention_softmax_scale=
1.0``), layers alternating global / local with a local band of 256
positions, and ``scan_layers=False`` (the layers are not homogeneous).
"""

from deepspeed_tpu_torch.models.transformer import Transformer, TransformerConfig

GPT_NEO_CONFIGS = {
    "gpt-neo-125m": dict(hidden_size=768, num_layers=12, num_heads=12),
    "gpt-neo-1.3b": dict(hidden_size=2048, num_layers=24, num_heads=16),
    "gpt-neo-2.7b": dict(hidden_size=2560, num_layers=32, num_heads=20),
}


def gpt_neo_config(name, **overrides):
    """The preset ``name`` with ``overrides``; ``attention_layers``
    alternates ("global", "local") over the final ``num_layers`` unless
    given."""
    if name not in GPT_NEO_CONFIGS:
        raise ValueError(f"unknown GPT-Neo model {name}; known: "
                         f"{sorted(GPT_NEO_CONFIGS)}")
    base = dict(vocab_size=50257, max_seq_len=2048, activation="gelu",
                position_embedding="learned", layernorm_epsilon=1e-5,
                tie_word_embeddings=True, attention_bias=False,
                attention_out_bias=True, attention_softmax_scale=1.0,
                window_size=256, scan_layers=False)
    base.update(GPT_NEO_CONFIGS[name])
    base.update(overrides)
    base.setdefault("ffn_hidden_size", 4 * base["hidden_size"])
    base.setdefault("attention_layers",
                    tuple(("global", "local")[i % 2]
                          for i in range(base["num_layers"])))
    return TransformerConfig(**base)


def gpt_neo_model(name, device="meta", **overrides):
    """A GPT-Neo model; built on ``device`` (default ``meta``: no storage
    until an inference engine places it)."""
    return Transformer(gpt_neo_config(name, **overrides), device=device)
