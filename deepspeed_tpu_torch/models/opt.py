"""OPT model family presets (port of ``deepspeed_tpu/models/opt.py``).

Architecture facts per the OPT paper / HF configs: learned positions,
ReLU MLP, pre-LN, tied embeddings for the LM head.
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
