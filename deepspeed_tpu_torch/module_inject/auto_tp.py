"""AutoTP — structural tensor-parallel rule discovery (port of
``deepspeed_tpu/module_inject/auto_tp.py``, which reads torch modules
already).

For models with no hand-written policy the reference walks the torch
module tree, finds the linears, and infers which must be row-parallel
(followed by the all-reduce) vs column-parallel.  The output is a list of
``(regex, kind)`` sharding rules over the converted model's flax parameter
paths, consumable by ``runtime/zero/partition.py`` ``tp_spec_for`` and
``parallel/tensor_parallel.py`` ``shard_module_(..., rules=)``.

Heuristic (same spirit as the reference's ``tp_parser``): within each
repeated transformer block, a linear whose *output* is hidden-size and which
terminates a branch (attention output / MLP down projection) is row-parallel;
linears producing non-hidden (heads, ffn, fused qkv) outputs are
column-parallel; embeddings shard on the vocab dim; 1-D params replicate.
"""

import re
from collections import Counter

from deepspeed_tpu_torch.utils.logging import logger


def _torch_linears(model):
    """[(qualified_name, in_features, out_features)] for Linear/Conv1D."""
    import torch.nn as torch_nn
    out = []
    for name, mod in model.named_modules():
        if isinstance(mod, torch_nn.Linear):
            out.append((name, mod.in_features, mod.out_features))
        elif type(mod).__name__ == "Conv1D":          # GPT2 style [in, out]
            w = mod.weight
            out.append((name, w.shape[0], w.shape[1]))
    return out


def _leaf(name):
    return name.split(".")[-1]


def _strip_layer_index(name):
    return re.sub(r"\.\d+\.", ".N.", name)


# HF leaf name → converted (flax Transformer) parameter names.  Conversion
# normalizes every architecture onto q/k/v/o_proj + gate/up/down_proj, so TP
# rules must target those names, not the HF ones.  Fused projections expand
# to all three; context-dependent names (c_proj, dense) disambiguate by the
# qualified module path.
def _converted_names(qualified_name):
    leaf = _leaf(qualified_name)
    in_attn = re.search(r"(attn|attention)", qualified_name) is not None
    table = {
        "q_proj": ["q_proj"], "k_proj": ["k_proj"], "v_proj": ["v_proj"],
        "query": ["q_proj"], "key": ["k_proj"], "value": ["v_proj"],
        "c_attn": ["q_proj", "k_proj", "v_proj"],
        "query_key_value": ["q_proj", "k_proj", "v_proj"],
        "qkv_proj": ["q_proj", "k_proj", "v_proj"],
        "o_proj": ["o_proj"], "out_proj": ["o_proj"],
        "gate_proj": ["gate_proj"],
        "fc1": ["up_proj"], "c_fc": ["up_proj"], "fc_in": ["up_proj"],
        "dense_h_to_4h": ["up_proj"], "wi": ["up_proj"], "up_proj": ["up_proj"],
        "fc2": ["down_proj"], "fc_out": ["down_proj"],
        "dense_4h_to_h": ["down_proj"], "wo": ["down_proj"],
        "down_proj": ["down_proj"],
    }
    if leaf == "c_proj":
        return ["o_proj"] if in_attn else ["down_proj"]
    if leaf == "dense":
        return ["o_proj"] if in_attn else ["down_proj"]
    return table.get(leaf, [leaf])


class AutoTP:
    """Derive TP rules from an HF torch model's structure."""

    def __init__(self, model):
        self.model = model
        self.hidden = getattr(model.config, "hidden_size",
                              getattr(model.config, "n_embd", None))

    def in_module_list(self):
        """Distinct per-layer linear signatures (debug aid, reference
        ``auto_tp.py`` module list)."""
        return sorted({_strip_layer_index(n)
                       for n, _, _ in _torch_linears(self.model)})

    def tp_rules(self):
        """[(regex-over-framework-param-paths, 'col'|'row'|'vocab'|'replicate')]

        Regexes target the *converted* (flax) parameter names, so the rules
        drop straight into ``build_sharding_plan(tp_rules=...)``."""
        linears = _torch_linears(self.model)
        if not linears or self.hidden is None:
            logger.warning("AutoTP: no linears or unknown hidden size; "
                           "falling back to name-based DEFAULT_TP_RULES")
            from deepspeed_tpu_torch.runtime.zero.partition import (
                DEFAULT_TP_RULES)
            return list(DEFAULT_TP_RULES)

        # Count how often each (stripped) linear name appears: repeated names
        # form the transformer trunk; singletons are embeddings/head.
        sig_count = Counter(_strip_layer_index(n) for n, _, _ in linears)
        rules = []
        emitted = set()
        seen = set()
        for name, fin, fout in linears:
            sig = _strip_layer_index(name)
            if sig in seen:
                continue
            seen.add(sig)
            if sig_count[sig] <= 1:
                # head-level linear: vocab-producing → column over vocab
                kind = "col" if fout != self.hidden else "replicate"
            elif fout == self.hidden and fin != self.hidden:
                kind = "row"        # ffn/heads → hidden: terminates a branch
            elif fout == self.hidden and fin == self.hidden:
                # square projection: attention out-proj (row) vs separate
                # q/k/v projection (col) — distinguish by role name.
                kind = "col" if re.search(r"(q|k|v|query|key|value)",
                                          _leaf(name)) else "row"
            else:
                kind = "col"
            for conv in _converted_names(name):
                if (conv, kind) not in emitted:
                    emitted.add((conv, kind))
                    rules.append((rf"{re.escape(conv)}.*(kernel|weight)$",
                                  kind))
        rules.append((r"(embed|wte|word_embeddings|embed_tokens).*"
                      r"(embedding|kernel|weight)$", "vocab"))
        rules.append((r".*(norm|ln_|layernorm|layer_norm|bias|scale).*",
                      "replicate"))
        logger.info(f"AutoTP derived {len(rules)} rules: {rules}")
        return rules


def get_tp_rules(model):
    return AutoTP(model).tp_rules()
