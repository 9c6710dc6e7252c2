"""HF-model conversion front end (port of
``deepspeed_tpu/module_inject/replace_module.py``): checkpoint-level,
one-shot and whole-model, onto the port's ``Transformer``::

    model = convert_hf_model(hf_model)          # HF torch model → port
    engine = deepspeed_tpu_torch.init_inference(hf_model)   # does it for you

An HF model is anything with ``.config`` (HF attribute names, among them
``model_type``) and ``.state_dict()``; ``transformers`` itself is imported
only to load a model by name.  :func:`load_megatron_model` reads a
Megatron-LM GPT checkpoint (a description json, TP shard files or a merged
state dict) into the same ``Transformer``.
"""

import re

from deepspeed_tpu_torch.models.transformer import params_from_flax
from deepspeed_tpu_torch.module_inject.containers import (
    ALL_POLICIES, UNPORTED_FAMILIES)
from deepspeed_tpu_torch.utils.logging import logger

# HF buffer keys that are not parameters and never need converting.
_IGNORED_KEY_PATTERNS = (".attn.bias", ".attn.masked_bias", "rotary_emb",
                         ".attention.bias", ".attention.masked_bias")


def policy_for(hf_config):
    """The injection policy of ``hf_config.model_type``; a family the port
    does not have yet raises ``NotImplementedError`` naming what it
    lacks."""
    for policy_cls in ALL_POLICIES:
        if policy_cls.match(hf_config):
            return policy_cls()
    model_type = getattr(hf_config, "model_type", None)
    supported = sorted(t for p in ALL_POLICIES for t in p.model_types)
    if model_type in UNPORTED_FAMILIES:
        raise NotImplementedError(
            f"model_type={model_type!r} needs "
            f"{UNPORTED_FAMILIES[model_type]}, which is not ported to "
            f"deepspeed_tpu_torch yet (see ROADMAP.md); supported: "
            f"{supported}")
    raise NotImplementedError(
        f"no injection policy for model_type={model_type!r}; supported: "
        f"{supported}")


def _materialize(model, flat):
    """Load a policy's flat ``{flax path: np.ndarray}`` dict into ``model``
    (built on ``meta``): a missing parameter or a shape that does not fit
    raises, a tensor the model does not use warns."""
    sd = params_from_flax(flat, model.config, unused="warn")
    model.load_state_dict(sd, strict=True, assign=True)
    return model


def convert_hf_model(model_or_name, **config_overrides):
    """(HF torch model | HF name/path) → a port ``Transformer`` on the CPU
    holding the converted weights in fp32 (the master dtype the engines
    take).

    ``config_overrides`` go into ``TransformerConfig``; the compute dtype
    comes through ``dtype=`` (e.g. ``dtype="bfloat16"``,
    ``use_flash_attention=False``, ``max_seq_len=...``)."""
    if isinstance(model_or_name, str):
        from transformers import AutoModelForCausalLM
        hf_model = AutoModelForCausalLM.from_pretrained(model_or_name)
    else:
        hf_model = model_or_name
    hf_config = hf_model.config
    policy = policy_for(hf_config)
    cfg = policy.build_config(hf_config, **config_overrides)
    sd = hf_model.state_dict()
    flat = policy.convert(sd, cfg)
    consumed_hint = [k for k in sd
                     if not any(p in k for p in _IGNORED_KEY_PATTERNS)]
    logger.info(f"converted {hf_config.model_type} model: "
                f"{len(consumed_hint)} HF tensors → {len(flat)} flax tensors, "
                f"{cfg.num_layers}L/{cfg.hidden_size}H")
    return _materialize(policy.build_model(cfg, device="meta"), flat)


def merged_megatron_state(checkpoint, megatron_v2=True):
    """A Megatron-LM GPT checkpoint (see :func:`load_megatron_model`) →
    ``(state dict, version)``: its shard files merged by
    ``MegatronSDLoader`` (the fused-QKV layout of ``version``: the
    description's, else 2.0 with ``megatron_v2``, else 1.0), the wrapper
    prefixes stripped.  MoE-GPT checkpoints (``mlp.deepspeed_moe``) raise:
    MoE is not ported."""
    from deepspeed_tpu_torch.module_inject.containers import MegatronGPTPolicy
    from deepspeed_tpu_torch.runtime.state_dict_factory import (
        get_sd_loader, get_sd_loader_json)
    version = None
    if isinstance(checkpoint, dict) and "checkpoints" not in checkpoint:
        # a merged state dict; a real Megatron save carries metadata
        # siblings ('iteration', 'checkpoint_version', ...) beside the
        # tensors: keep the arrays, refuse only a dict without any
        sd = {k: v for k, v in checkpoint.items() if hasattr(v, "shape")}
        if not sd:
            raise ValueError(
                "checkpoint dict is neither a checkpoint-description json "
                "(no 'checkpoints' key) nor a merged state dict (no array "
                f"values among keys: {list(checkpoint)[:5]})")
    else:
        if isinstance(checkpoint, (str, dict)) or hasattr(checkpoint,
                                                          "__fspath__"):
            _, ckpt_list, version = get_sd_loader_json(
                checkpoint if isinstance(checkpoint, dict)
                else str(checkpoint))
        else:
            ckpt_list = [str(c) for c in checkpoint]
        if not version:               # merge must know the fused-QKV layout
            version = 2.0 if megatron_v2 else 1.0
        sd = get_sd_loader(ckpt_list, version=version).merge_state_dict()
    sd = MegatronGPTPolicy.normalize(sd)
    if any(".deepspeed_moe." in k for k in sd):
        raise NotImplementedError(
            "a Megatron MoE-GPT checkpoint (mlp.deepspeed_moe experts) needs "
            "MoE, which is not ported to deepspeed_tpu_torch yet (see "
            "ROADMAP.md)")
    return sd, version


def load_megatron_model(checkpoint, num_heads=None, megatron_v2=True,
                        **config_overrides):
    """A Megatron-LM GPT checkpoint → ``(model, state_dict)``: a port
    ``Transformer`` on the CPU holding its weights in fp32 (as
    :func:`convert_hf_model`) and its ``state_dict``, the global weights
    an engine's ``set_params`` takes at any tensor-parallel size.

    ``checkpoint``: a DeepSpeed checkpoint-description json (a path or a
    dict, reference ``SDLoaderFactory.get_sd_loader_json``), a list of TP
    shard files, or an already-merged flat state dict.  TP shards are
    folded by ``MegatronSDLoader.merge_state_dict``; the model's widths
    come from the merged tensors (the head count cannot: pass
    ``num_heads``).  ``megatron_v2`` picks the fused-QKV row layout of the
    policy, and of the merge of a checkpoint whose description names no
    version (as in the JAX package).  MoE-GPT checkpoints
    (``mlp.deepspeed_moe``) raise: MoE is not ported."""
    import numpy as np
    from deepspeed_tpu_torch.module_inject.containers import MegatronGPTPolicy
    sd, _ = merged_megatron_state(checkpoint, megatron_v2)
    if num_heads is None:
        raise ValueError("num_heads is not recoverable from a megatron "
                         "state dict — pass num_heads=")
    emb_key = "embedding.word_embeddings.weight" \
        if "embedding.word_embeddings.weight" in sd else "word_embeddings.weight"
    pos_key = emb_key.replace("word", "position")
    layer_ids = {int(m.group(1)) for k in sd
                 if (m := re.match(r"transformer\.layers\.(\d+)\.", k))}
    emb = np.shape(sd[emb_key])

    class _Args:                              # megatron arg namespace
        vocab_size, hidden_size = emb
        num_layers = max(layer_ids) + 1
        num_attention_heads = num_heads
        ffn_hidden_size = np.shape(
            sd["transformer.layers.0.mlp.dense_h_to_4h.weight"])[0]
        max_position_embeddings = np.shape(sd[pos_key])[0]

    policy = MegatronGPTPolicy()
    policy.megatron_v2 = megatron_v2
    cfg = policy.build_config(_Args(), **config_overrides)
    flat = policy.convert(sd, cfg)
    logger.info(f"converted megatron-gpt checkpoint: {len(sd)} tensors → "
                f"{len(flat)} flax tensors, {cfg.num_layers}L/"
                f"{cfg.hidden_size}H")
    model = _materialize(policy.build_model(cfg, device="meta"), flat)
    return model, model.state_dict()
