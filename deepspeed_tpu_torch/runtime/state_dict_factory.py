"""Checkpoint shard loaders with tensor-parallel resharding (port of
``deepspeed_tpu/runtime/state_dict_factory.py``; reference
``runtime/state_dict_factory.py`` ``SDLoaderFactory`` /
``MegatronSDLoader``): load a Megatron-style checkpoint saved at one TP
degree into a model running at another, merging or splitting its
TP-sharded weights.

Shards are ``.npz`` files or torch files (``.pt`` / ``.bin``), read on the
host into numpy arrays.  "Merge" concatenates the shard files along each
weight's TP axis; "split" cuts a rank's slice.  The axis conventions are
Megatron's: q / k / v and intermediate weights are column-parallel
(concatenated on the output dim, axis 0 of a torch ``[out, in]`` weight),
output projections row-parallel (the input dim, axis 1).
"""

import json
import os
import pickle
import re

import numpy as np

AUTO_TP_VERSION = 1.0

# Megatron/HF column-parallel (output-dim-sharded) weight name patterns;
# everything else matching *_proj/dense is row-parallel
COLUMN_PARALLEL_PATTERNS = (
    r"q_proj", r"k_proj", r"v_proj", r"query", r"key", r"value",
    r"query_key_value", r"qkv", r"gate_proj", r"up_proj", r"fc1",
    r"intermediate", r"h_to_4h", r"wi", r"in_proj",
)
ROW_PARALLEL_PATTERNS = (
    r"o_proj", r"out_proj", r"down_proj", r"fc2", r"dense_4h_to_h",
    r"attention\.dense", r"attn\.dense", r"wo",
)

# fused QKV weights need version-aware merge/split (see _merge_qkv)
FUSED_QKV_RE = re.compile(r"(^|[._/])(query_key_value|qkv)([._/]|$)")
# megatron VocabParallelEmbedding shards the vocab dim; positions replicate
VOCAB_EMBED_RE = re.compile(r"word_embeddings\.weight$")


def get_sd_loader_json(json_file_or_dict):
    """Parse a DeepSpeed checkpoint description json (reference
    ``SDLoaderFactory.get_sd_loader_json``): returns ``(type, paths,
    version)``.  ``checkpoints`` is a list of shard files or a BLOOM-style
    ``{tp_rank: [files]}`` dict; ``base_dir`` prefixes each path."""
    if isinstance(json_file_or_dict, dict):
        data = json_file_or_dict
    else:
        with open(json_file_or_dict) as f:
            data = json.load(f)
    ckpt_type = data.get("type", "Megatron")
    ckpt_list = data.get("checkpoints", [])
    if isinstance(ckpt_list, dict):  # BLOOM-style {tp_rank: [files]}
        ckpt_list = [f for fs in ckpt_list.values()
                     for f in (fs if isinstance(fs, list) else [fs])]
    version = data.get("version", 0.0)
    base_dir = data.get("base_dir", "")
    if base_dir:
        ckpt_list = [os.path.join(base_dir, c) for c in ckpt_list]
    return ckpt_type, ckpt_list, version


def get_sd_loader(ckpt_list, sd_type="Megatron", version=None):
    """Factory (reference ``SDLoaderFactory.get_sd_loader``)."""
    return MegatronSDLoader(ckpt_list, version)


def _classify(name):
    """Classify by token-boundary-anchored match: short patterns like 'wo'
    must not fire inside unrelated names ('word_embeddings')."""
    def hit(pat):
        return re.search(rf"(^|[._/]){pat}([._/]|$)", name)

    for pat in COLUMN_PARALLEL_PATTERNS:
        if hit(pat):
            return "column"
    for pat in ROW_PARALLEL_PATTERNS:
        if hit(pat):
            return "row"
    return "replicated"


def _host_array(v):
    """A shard's tensor as a numpy array (bf16 widened to fp32, exactly:
    numpy has no bf16)."""
    if hasattr(v, "detach"):
        import torch
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.numpy()
    return np.asarray(v)


def _torch_load(path):
    """A torch shard file, read with ``weights_only`` unpickling; a file
    that needs full (code-executing) unpickling — a Megatron save with its
    ``args`` namespace — loads only with
    ``DSTPU_ALLOW_PICKLE_CHECKPOINTS=1``, as the engines' ``load_checkpoint``."""
    import torch
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except (pickle.UnpicklingError, RuntimeError):
        if os.environ.get("DSTPU_ALLOW_PICKLE_CHECKPOINTS") != "1":
            raise ValueError(
                f"{path}: not loadable with weights_only unpickling; full "
                "pickle execution is disabled for untrusted files. Set "
                "DSTPU_ALLOW_PICKLE_CHECKPOINTS=1 to load a shard you "
                "trust.") from None
        return torch.load(path, map_location="cpu", weights_only=False)


class SDLoaderBase:

    def __init__(self, ckpt_list, version=None):
        self.ckpt_list = sorted(ckpt_list)
        self.version = version

    def __len__(self):
        return len(self.ckpt_list)

    def load_shard(self, path):
        """One shard file → flat ``{name: np.ndarray}`` (``.npz``, or a
        torch ``.pt`` / ``.bin`` file whose state dict may sit under
        ``"module"``)."""
        path = str(path)
        if path.endswith(".npz"):
            with np.load(path, allow_pickle=False) as z:
                return {k: np.asarray(z[k]) for k in z.files}
        sd = _torch_load(path)
        if isinstance(sd, dict) and "module" in sd:
            sd = sd["module"]
        return {k: _host_array(v) for k, v in sd.items()
                if hasattr(v, "shape")}


class MegatronSDLoader(SDLoaderBase):
    """Merge/split Megatron-style TP shards (reference
    ``state_dict_factory.py`` ``MegatronSDLoader.merge_state_dict`` /
    ``split_state_dict``).  ``quantize`` is accepted for the reference's
    signature and, as in the JAX package, changes nothing: weight
    quantization happens when the engine takes the weights."""

    def merge_state_dict(self, mp_world_size=1, quantize=False, **kw):
        """All shards → one full state dict (TP degree n → 1).

        Column-parallel weights concatenate on the output axis, row-parallel
        on the input axis; biases of row-parallel layers and all replicated
        tensors are taken from rank 0 (they are identical across ranks)."""
        shards = [self.load_shard(p) for p in self.ckpt_list]
        if len(shards) == 1:
            return shards[0]
        merged = {}
        for name, first in shards[0].items():
            parts = [s[name] for s in shards]
            kind = _classify(name)
            if FUSED_QKV_RE.search(name):
                # fused QKV needs version-aware merging (reference
                # ``merge_query_key_value``): v1 shards are internally
                # [q_r|k_r|v_r], so naive concat would interleave per-rank
                # q/k/v blocks.  Megatron v2 interleaves per head — plain
                # concat on the output axis is correct there.
                merged[name] = self._merge_qkv(parts, name)
            elif VOCAB_EMBED_RE.search(name) and first.ndim == 2 \
                    and (any(p.shape != first.shape for p in parts[1:])
                         or not all(np.array_equal(p, first)
                                    for p in parts[1:])):
                # megatron VocabParallelEmbedding: differing shards → the
                # vocab dim is TP-sharded, concatenate it (shape check first:
                # unevenly-split shards must not hit the elementwise compare).
                # Identical shards mean a replicated embedding
                # (inference-export checkpoints).
                merged[name] = np.concatenate(parts, axis=0)
            elif first.ndim == 0 or kind == "replicated":
                merged[name] = parts[0]
            elif first.ndim == 1:
                # column-parallel bias shards concatenate; row-parallel
                # biases are replicated across ranks.  Decide by kind, not
                # by value equality — zero-initialized column biases must
                # still concatenate.
                merged[name] = np.concatenate(parts, axis=0) \
                    if kind == "column" else parts[0]
            elif kind == "column":
                # torch Linear weight [out, in] → concat outputs on axis 0;
                # flax kernels [in, out] → axis -1.  Heuristic: torch layout
                # when name endswith 'weight'
                axis = 0 if name.endswith("weight") else -1
                merged[name] = np.concatenate(parts, axis=axis)
            else:  # row
                axis = 1 if name.endswith("weight") else 0
                merged[name] = np.concatenate(parts, axis=axis)
        return merged

    def _merge_qkv(self, parts, name):
        """Merge fused query_key_value shards (output axis 0 in torch
        layout).  ``version >= 2`` (or unset) → head-interleaved rows, plain
        concat.  ``version < 2`` → each shard is [q_r|k_r|v_r]: split every
        shard into thirds and concatenate per projection."""
        axis = 0
        if self.version is None or float(self.version) >= 2.0:
            return np.concatenate(parts, axis=axis)
        thirds = [np.split(p, 3, axis=axis) for p in parts]
        return np.concatenate(
            [np.concatenate([t[j] for t in thirds], axis=axis)
             for j in range(3)], axis=axis)

    def split_state_dict(self, mp_world_size, mp_rank, quantize=False, **kw):
        """Full state dict → this rank's TP shard (TP degree 1 → n)."""
        full = self.merge_state_dict()
        out = {}
        for name, w in full.items():
            kind = _classify(name)
            if FUSED_QKV_RE.search(name) \
                    and (self.version is not None
                         and float(self.version) < 2.0):
                # v1 fused QKV: rank r takes [q_r|k_r|v_r]
                q, k, v = np.split(w, 3, axis=0)
                out[name] = np.concatenate(
                    [np.split(t, mp_world_size, axis=0)[mp_rank]
                     for t in (q, k, v)], axis=0)
                continue
            if VOCAB_EMBED_RE.search(name) and w.ndim == 2:
                # inverse of the merge-side vocab concat: shard the vocab dim
                if w.shape[0] % mp_world_size:
                    raise ValueError(f"{name}: vocab {w.shape[0]} not "
                                     f"divisible by TP degree "
                                     f"{mp_world_size}")
                out[name] = np.split(w, mp_world_size, axis=0)[mp_rank]
                continue
            if w.ndim == 0 or kind == "replicated":
                out[name] = w
                continue
            if kind == "column":
                axis = 0 if (w.ndim > 1 and name.endswith("weight")) else \
                    (w.ndim - 1 if w.ndim > 1 else 0)
            else:
                if w.ndim == 1:
                    out[name] = w  # row-parallel bias replicates
                    continue
                axis = 1 if name.endswith("weight") else 0
            if w.shape[axis] % mp_world_size:
                raise ValueError(f"{name}: dim {w.shape[axis]} not divisible "
                                 f"by mp_world_size={mp_world_size}")
            out[name] = np.split(w, mp_world_size, axis=axis)[mp_rank]
        return out

    def load(self, mp_world_size, mp_rank, quantize=False, **kw):
        """Reference ``SDLoaderBase.load``: this TP rank's state dict —
        the shard file itself when the degrees match, a merge of its group
        of files when the checkpoint has more, a split of its file when it
        has fewer."""
        n = len(self.ckpt_list)
        if n == mp_world_size:
            return self.load_shard(self.ckpt_list[mp_rank])
        if n > mp_world_size:
            if n % mp_world_size:
                raise ValueError(f"{n} shard files do not merge into "
                                 f"{mp_world_size} ranks")
            per = n // mp_world_size
            group = MegatronSDLoader(
                self.ckpt_list[mp_rank * per:(mp_rank + 1) * per], self.version)
            return group.merge_state_dict()
        if mp_world_size % n:
            raise ValueError(f"{n} shard files do not split into "
                             f"{mp_world_size} ranks")
        per = mp_world_size // n
        shard = MegatronSDLoader([self.ckpt_list[mp_rank // per]], self.version)
        return shard.split_state_dict(per, mp_rank % per)


SDLoaderFactory = type("SDLoaderFactory", (), {
    "get_sd_loader_json": staticmethod(get_sd_loader_json),
    "get_sd_loader": staticmethod(get_sd_loader),
})
