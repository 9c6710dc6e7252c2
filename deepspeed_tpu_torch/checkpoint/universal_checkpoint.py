"""Universal checkpoint (port of
``deepspeed_tpu/checkpoint/universal_checkpoint.py``; reference
``deepspeed/checkpoint/universal_checkpoint.py`` and ``ds_to_universal``):
fold a training tag into per-parameter fp32 files that load at any
tensor- and data-parallel size and ZeRO stage::

    <out_dir>/
      zero/<flax/param/path>/fp32.npy
      zero/<flax/param/path>/<moment>.npy      (exp_avg, exp_avg_sq)
      universal_meta.pkl

The layout is the JAX package's, under the JAX model's flax paths and
layouts (:class:`~.deepspeed_checkpoint.ZeROCheckpoint`), so a directory
either package writes loads into the other's engine.  Loading hands each
full tensor to the live engine's own restore targets, which keep this
rank's piece of it: the tp slice (``parallel/tensor_parallel.py``
``TPLeaf.take``), then the ZeRO-1/2 shard (``runtime/zero/partition.py``)
or ZeRO-3's flat unit buffer (``runtime/zero/stage3.py``).
"""

import os
import pickle

import numpy as np
import torch

from deepspeed_tpu_torch.checkpoint.deepspeed_checkpoint import ZeROCheckpoint
from deepspeed_tpu_torch.models.transformer import Transformer
from deepspeed_tpu_torch.runtime.checkpoint_engine.checkpoint_engine import (
    copy_groups)
from deepspeed_tpu_torch.utils.logging import logger

UNIVERSAL_META = "universal_meta.pkl"
ZERO_SUBDIR = "zero"
FP32_NAME = "fp32.npy"


def _param_dir(out_dir, name):
    return os.path.join(str(out_dir), ZERO_SUBDIR, name)


def _fp32(a):
    return a.astype(np.float32) if np.issubdtype(a.dtype, np.floating) else a


def convert_to_universal(ckpt_dir, out_dir, tag=None):
    """Offline conversion: a training tag (``latest``'s when ``tag`` is
    None) → the universal layout under ``out_dir``."""
    ckpt = ZeROCheckpoint(ckpt_dir, tag=tag)
    flat_params = ckpt.flax_parameters()
    moments = ckpt.flat_optimizer_moments()
    os.makedirs(out_dir, exist_ok=True)
    for name, value in flat_params.items():
        pdir = _param_dir(out_dir, name)
        os.makedirs(pdir, exist_ok=True)
        np.save(os.path.join(pdir, FP32_NAME), _fp32(value))
        for field, per_param in moments.items():
            if name in per_param:
                np.save(os.path.join(pdir, f"{field}.npy"),
                        _fp32(per_param[name]))
    meta = dict(ckpt.meta)
    meta["universal_source_tag"] = ckpt.tag
    meta["param_names"] = sorted(flat_params)
    meta["moment_fields"] = sorted(moments)
    with open(os.path.join(out_dir, UNIVERSAL_META), "wb") as f:
        pickle.dump(meta, f)
    logger.info(f"universal checkpoint: {len(flat_params)} params → {out_dir}")
    return out_dir


def load_universal_meta(universal_dir):
    with open(os.path.join(str(universal_dir), UNIVERSAL_META), "rb") as f:
        return pickle.load(f)


def load_hp_checkpoint_state(universal_dir, param_name):
    """Per-parameter high-precision state (reference
    ``universal_checkpoint.py:12``): ``{'fp32': arr, '<moment>': arr}``."""
    pdir = _param_dir(universal_dir, param_name)
    if not os.path.isdir(pdir):
        raise KeyError(f"no universal state for parameter {param_name!r}")
    return {fname[:-4]: np.load(os.path.join(pdir, fname))
            for fname in os.listdir(pdir) if fname.endswith(".npy")}


def _hp_state(universal_dir, path):
    """A parameter's state under its per-layer flax path, or its row of a
    stacked ``layers/`` leaf (a JAX model with ``scan_layers=True``); None
    when the directory has neither."""
    try:
        return load_hp_checkpoint_state(universal_dir, path)
    except KeyError:
        head, _, rest = path.partition("/layers_")
        i, _, leaf = rest.partition("/")
        if not rest or not i.isdigit():
            return None
        try:
            state = load_hp_checkpoint_state(universal_dir,
                                             f"{head}/layers/{leaf}")
        except KeyError:
            return None
        return {k: v[int(i)] for k, v in state.items()}


def load_universal_into_engine(engine, universal_dir,
                               load_optimizer_states=True):
    """Restore a universal directory into a live engine at whatever
    topology it runs (the reference's ``load_universal_checkpoint`` path,
    ``engine.py:772``): every rank of the engine's groups calls it and
    reads each full tensor, and keeps its piece.  A parameter the directory
    lacks keeps its value (a warning), as do its moments; the step
    counters and the LR schedule come from the directory's metadata.
    Under ``offload_optimizer`` the host optimizer restarts from the loaded
    weights with zero moments (the moments are not read)."""
    meta = load_universal_meta(universal_dir)
    names = [n for n, p in engine.module.named_parameters()
             if p.requires_grad]
    # the layouts of the whole model (a ZeRO-3 module holds placeholders)
    whole = Transformer(engine.module.config, device="meta")
    paths, lay = whole.flax_paths(), whole.jax_layouts()
    targets = engine._restore_targets(load_optimizer_states,
                                      load_module_only=False)
    opt = targets.get("optimizer")
    fields = [f for f in (opt._fields if opt is not None else ())
              if f in meta.get("moment_fields", ())
              and getattr(opt, f) is not None]
    source = {"module": {}, "optimizer": {f: [] for f in fields}}
    kept = {"module": {}, "optimizer": {f: [] for f in fields}}

    def port_layout(name, arr):
        t = torch.from_numpy(np.ascontiguousarray(arr))
        return lay[name][1](t) if name in lay else t

    for name in names:
        state = _hp_state(universal_dir, paths[name])
        if state is None:
            logger.warning(f"universal load: {paths[name]} missing, keeping "
                           f"current")
        else:
            source["module"][name] = port_layout(name, state["fp32"])
            kept["module"][name] = targets["module"][name]
        for f in fields:
            have = state is not None and f in state
            source["optimizer"][f].append(
                port_layout(name, state[f]) if have else None)
            kept["optimizer"][f].append(getattr(opt, f)[names.index(name)]
                                        if have else None)
    copy_groups(kept, {g: v for g, v in source.items() if v}, strict=True)
    engine._restore_host_optimizer(False, None)
    engine._restore_meta(meta, load_lr_scheduler_states=True,
                         load_module_only=False)
    logger.info(f"universal checkpoint loaded from {universal_dir} at "
                f"tp {engine.tp_world} x dp {engine.dp_world}")
    return engine
