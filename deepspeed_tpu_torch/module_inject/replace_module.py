"""HF-model conversion front end (port of
``deepspeed_tpu/module_inject/replace_module.py``): checkpoint-level,
one-shot and whole-model, onto the port's ``Transformer``::

    model = convert_hf_model(hf_model)          # HF torch model → port
    engine = deepspeed_tpu_torch.init_inference(hf_model)   # does it for you

An HF model is anything with ``.config`` (HF attribute names, among them
``model_type``) and ``.state_dict()``; ``transformers`` itself is imported
only to load a model by name.
"""

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
