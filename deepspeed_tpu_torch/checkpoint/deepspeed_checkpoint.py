"""Offline checkpoint inspection (port of
``deepspeed_tpu/checkpoint/deepspeed_checkpoint.py``; reference
``deepspeed/checkpoint/deepspeed_checkpoint.py:33``): open a checkpoint
directory written by ``DeepSpeedEngine.save_checkpoint`` without a live
engine, enumerate tags, parameters and shapes, and read the arrays on the
host.

The port's tags hold one file per tensor (``runtime/checkpoint_engine``),
so parameter names and shapes come from the tag's index without reading
any tensor.  A tag holds global tensors at any tensor- and data-parallel
size and ZeRO stage (the engine gathers every sharded tensor on save), so
:class:`ZeROCheckpoint` reads the moments of any of them the same way.
"""

import functools
import math
import os
import pickle
import re

from deepspeed_tpu_torch.runtime.checkpoint_engine.checkpoint_engine import (
    INDEX_NAME, TorchCheckpointEngine, _read_index)
from deepspeed_tpu_torch.runtime.fault.manifest import read_latest


class DeepSpeedCheckpoint:
    """View over one checkpoint directory (possibly many tags)."""

    def __init__(self, ckpt_dir, tag=None):
        self.ckpt_dir = str(ckpt_dir)
        if not os.path.isdir(self.ckpt_dir):
            raise FileNotFoundError(f"no checkpoint directory at {ckpt_dir}")
        self.tag = tag or self._latest_tag()
        self.state_path = os.path.join(self.ckpt_dir, str(self.tag), "state")
        if not os.path.isdir(self.state_path):
            raise FileNotFoundError(f"tag {self.tag!r} has no state at "
                                    f"{self.state_path}")
        self._meta = None
        self._arrays = {}

    # ------------------------------------------------------------------ #
    def _latest_tag(self):
        latest = read_latest(self.ckpt_dir)
        if latest:
            return latest
        tags = self.get_tags()
        if not tags:
            raise FileNotFoundError(f"no tags under {self.ckpt_dir}")

        # natural sort, so global_step10 beats global_step9
        def key(tag):
            nums = re.findall(r"\d+", tag)
            return (int(nums[-1]) if nums else -1, tag)
        return max(tags, key=key)

    def get_tags(self):
        return [name for name in sorted(os.listdir(self.ckpt_dir))
                if os.path.isdir(os.path.join(self.ckpt_dir, name, "state"))]

    # ------------------------------------------------------------------ #
    @property
    def meta(self):
        if self._meta is None:
            with open(os.path.join(self.state_path, "meta.pkl"), "rb") as f:
                self._meta = pickle.load(f)
        return self._meta

    @property
    def global_steps(self):
        return self.meta.get("global_steps", 0)

    @property
    def ds_config(self):
        return self.meta.get("ds_config", {})

    def _index(self):
        index = _read_index(os.path.join(self.state_path, "arrays"))
        if index is None:
            raise FileNotFoundError(f"tag {self.tag!r} has no arrays "
                                    f"({INDEX_NAME} missing)")
        return index

    def _group(self, group):
        """One array group, read once (the others stay on disk)."""
        if group not in self._arrays:
            arrays, _ = TorchCheckpointEngine().load(self.state_path,
                                                     groups=(group,))
            self._arrays[group] = (arrays or {}).get(group)
        return self._arrays[group]

    # ------------------------------------------------------------------ #
    def module_state(self):
        """The module's ``state_dict`` (CPU tensors)."""
        return self._group("module")

    def optimizer_state(self):
        """``{field: [tensor, ...]}`` in ``engine.params`` order (None
        fields stay None), or None when the tag saved none."""
        return self._group("optimizer")

    def flat_parameters(self):
        """``{name: tensor}`` over the module's parameters."""
        return dict(self.module_state() or {})

    def parameter_names(self):
        return sorted(self.parameter_shapes())

    def parameter_shapes(self):
        """``{name: shape}`` from the tag's index; no tensor is read."""
        return {e["path"].split("/", 1)[1]: tuple(e["shape"])
                for e in self._index()["leaves"]
                if e["path"].startswith("module/") and "shape" in e}

    def num_parameters(self):
        return sum(math.prod(s) for s in self.parameter_shapes().values())


class ZeROCheckpoint(DeepSpeedCheckpoint):
    """Optimizer-state-centric view (reference ``zero_checkpoint.py:17``):
    the parameters and the optimizer's moments under the JAX model's flax
    paths and layouts, the names and layouts of the JAX package's
    ``ZeROCheckpoint`` (``params/layers_0/attn/q_proj/kernel`` ``[h, H,
    D]``, moment fields ``exp_avg`` / ``exp_avg_sq``), so that a universal
    directory means the same on both sides.  The model comes from the
    tag's ``model_config`` (the port's own ``meta.pkl`` key)."""

    @functools.cached_property
    def _model(self):
        """The tag's model on ``meta``: its names, flax paths, layouts."""
        from deepspeed_tpu_torch.models.transformer import (
            Transformer, TransformerConfig)
        cfg = self.meta.get("model_config")
        if cfg is None:
            raise ValueError(f"tag {self.tag!r} records no model_config: its "
                             f"flax paths are unknown")
        return Transformer(TransformerConfig(**cfg), device="meta")

    def _to_flax(self, named):
        """``{port name: tensor}`` → ``{flax path: np.ndarray}`` (the JAX
        layouts, the dtype as saved)."""
        model = self._model
        paths, lay = model.flax_paths(), model.jax_layouts()
        out = {}
        for name, t in named.items():
            if name in lay:
                t = lay[name][0](t)
            out[paths[name]] = t.detach().contiguous().numpy()
        return out

    def flax_parameters(self):
        """``{flax path: np.ndarray}`` over the module's parameters."""
        names = dict(self._model.named_parameters())
        return self._to_flax({k: v for k, v in self.module_state().items()
                              if k in names})

    def flat_optimizer_moments(self):
        """``{field: {flax path: np.ndarray}}`` for each optimizer-state
        field that holds one tensor per parameter (Adam's ``exp_avg`` /
        ``exp_avg_sq``); empty when the tag saved no optimizer state (an
        offloaded optimizer's host state is not read)."""
        opt = self.optimizer_state()
        if not opt:
            return {}
        names = [n for n, p in self._model.named_parameters()
                 if p.requires_grad]
        return {field: self._to_flax(dict(zip(names, per_param)))
                for field, per_param in opt.items()
                if isinstance(per_param, list) and len(per_param) == len(names)}
