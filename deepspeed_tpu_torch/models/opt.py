"""OPT and Llama model presets (port of ``deepspeed_tpu/models/opt.py``).

Architecture facts per the OPT paper / HF configs: learned positions,
ReLU MLP, pre-LN, tied embeddings for the LM head.  The Llama presets
are the JAX package's as they stand: rope (theta 10000, half-split),
RMSNorm with the config's default epsilon 1e-5, SwiGLU, an untied head,
no biases.
"""

from deepspeed_tpu_torch.models.transformer import Transformer, TransformerConfig

OPT_CONFIGS = {
    "opt-125m": dict(hidden_size=768, num_layers=12, num_heads=12,
                     ffn_hidden_size=3072),
    "opt-350m": dict(hidden_size=1024, num_layers=24, num_heads=16,
                     ffn_hidden_size=4096),
    "opt-1.3b": dict(hidden_size=2048, num_layers=24, num_heads=32,
                     ffn_hidden_size=8192),
    "opt-2.7b": dict(hidden_size=2560, num_layers=32, num_heads=32,
                     ffn_hidden_size=10240),
    "opt-6.7b": dict(hidden_size=4096, num_layers=32, num_heads=32,
                     ffn_hidden_size=16384),
    "opt-13b": dict(hidden_size=5120, num_layers=40, num_heads=40,
                    ffn_hidden_size=20480),
    "opt-30b": dict(hidden_size=7168, num_layers=48, num_heads=56,
                    ffn_hidden_size=28672),
    "opt-66b": dict(hidden_size=9216, num_layers=64, num_heads=72,
                    ffn_hidden_size=36864),
}


def opt_config(name, **overrides):
    if name not in OPT_CONFIGS:
        raise ValueError(f"unknown OPT model {name}; known: {sorted(OPT_CONFIGS)}")
    base = dict(vocab_size=50272, max_seq_len=2048, activation="relu",
                position_embedding="learned", rms_norm=False,
                tie_word_embeddings=True)
    base.update(OPT_CONFIGS[name])
    base.update(overrides)
    return TransformerConfig(**base)


def opt_model(name, device="meta", **overrides):
    """An OPT model; built on ``device`` (default ``meta``: no storage
    until an inference engine places it)."""
    return Transformer(opt_config(name, **overrides), device=device)


# Llama-style presets: the rope / RMSNorm / SwiGLU / GQA paths (values as
# in the JAX package's LLAMA_CONFIGS)
LLAMA_CONFIGS = {
    "llama-tiny": dict(hidden_size=256, num_layers=4, num_heads=8,
                       num_kv_heads=4, ffn_hidden_size=688, vocab_size=32000),
    "llama-7b": dict(hidden_size=4096, num_layers=32, num_heads=32,
                     ffn_hidden_size=11008, vocab_size=32000),
    "llama-13b": dict(hidden_size=5120, num_layers=40, num_heads=40,
                      ffn_hidden_size=13824, vocab_size=32000),
}


def llama_config(name, **overrides):
    if name not in LLAMA_CONFIGS:
        raise ValueError(f"unknown Llama model {name}; known: "
                         f"{sorted(LLAMA_CONFIGS)}")
    base = dict(max_seq_len=2048, activation="silu", gated_mlp=True,
                position_embedding="rope", rms_norm=True,
                tie_word_embeddings=False)
    base.update(LLAMA_CONFIGS[name])
    base.update(overrides)
    return TransformerConfig(**base)


def llama_model(name, device="meta", **overrides):
    """A Llama model; built on ``device`` (default ``meta``: no storage
    until an inference engine places it)."""
    return Transformer(llama_config(name, **overrides), device=device)
