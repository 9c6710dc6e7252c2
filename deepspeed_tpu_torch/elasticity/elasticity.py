"""Elastic training config solver (a copy of
``deepspeed_tpu/elasticity/elasticity.py``).

Parity with reference ``elasticity/elasticity.py`` (v0.1 ``:83``, v0.2
``:126``, ``compute_elastic_config:233``): given candidate micro-batch sizes
and a chip-count range, find configurations where

    global_batch = micro_batch × gradient_accumulation × world_size

stays constant as the world resizes — so a preempted or resized job resumes
with identical optimization dynamics.
"""

import json

from deepspeed_tpu_torch.utils.logging import logger

ELASTICITY = "elasticity"
LATEST_ELASTICITY_VERSION = 0.2
MINIMUM_DEEPSPEED_VERSION = "0.3.8"


class ElasticityError(Exception):
    pass


class ElasticityConfigError(ElasticityError):
    pass


class ElasticityIncompatibleWorldSize(ElasticityError):
    pass


def get_candidate_batch_sizes(base_list, max_acceptable_batch_size):
    """All batch sizes b = base * 2^k ≤ max (reference v0.1 candidate gen)."""
    candidates = set()
    for base in base_list:
        b = base
        while b <= max_acceptable_batch_size:
            candidates.add(b)
            b *= 2
    return sorted(candidates)


def get_compatible_gpus_v01(micro_batches, max_acceptable_batch_size,
                            min_gpus=1, max_gpus=10000):
    """v0.1: find (final_batch, valid_world_sizes) (reference ``:83``)."""
    candidates = get_candidate_batch_sizes(micro_batches,
                                           max_acceptable_batch_size)
    if not candidates:
        raise ElasticityConfigError(
            f"no candidate batch size ≤ {max_acceptable_batch_size} "
            f"from micro batches {micro_batches}")
    final_batch = max(candidates)
    valid = set()
    for w in range(min_gpus, max_gpus + 1):
        for mb in micro_batches:
            if final_batch % (mb * w) == 0:
                valid.add(w)
                break
    return final_batch, sorted(valid)


def get_compatible_gpus_v02(micro_batches, max_acceptable_batch_size,
                            current_num_gpus, min_gpus=1, max_gpus=10000,
                            prefer_larger=True, num_gpus_per_node=1):
    """v0.2: node-granular worlds (reference ``:126``)."""
    candidates = get_candidate_batch_sizes(micro_batches,
                                           max_acceptable_batch_size)
    valid_worlds = []
    for n_nodes in range(max(1, min_gpus // num_gpus_per_node),
                         max_gpus // num_gpus_per_node + 1):
        w = n_nodes * num_gpus_per_node
        if any(b % (mb * w) == 0 for b in candidates for mb in micro_batches):
            valid_worlds.append(w)
    if not valid_worlds:
        raise ElasticityConfigError("no compatible world sizes found")
    final_batch, _ = get_compatible_gpus_v01(micro_batches,
                                             max_acceptable_batch_size,
                                             min_gpus, max_gpus)
    return final_batch, valid_worlds


def _get_microbatch_gas(final_batch, micro_batches, world_size, prefer_larger):
    options = []
    for mb in micro_batches:
        if final_batch % (mb * world_size) == 0:
            options.append((mb, final_batch // (mb * world_size)))
    if not options:
        raise ElasticityIncompatibleWorldSize(
            f"world size {world_size} incompatible with global batch "
            f"{final_batch} and micro batches {micro_batches}")
    options.sort(key=lambda t: t[0], reverse=prefer_larger)
    return options[0]


def compute_elastic_config(ds_config, target_deepspeed_version=None,
                           world_size=0, return_microbatch=False):
    """Resolve the elastic config (reference ``compute_elastic_config:233``).

    Returns (final_batch_size, valid_world_sizes[, micro_batch]) and, when
    ``world_size`` > 0, asserts compatibility and computes the
    (micro_batch, gas) pair.
    """
    if isinstance(ds_config, str):
        with open(ds_config) as f:
            ds_config = json.load(f)
    elastic = ds_config.get(ELASTICITY)
    if not elastic or not elastic.get("enabled", False):
        raise ElasticityConfigError("'elasticity' block missing or disabled")
    micro_batches = elastic.get("micro_batch_sizes", [2, 4, 6])
    max_batch = elastic.get("max_train_batch_size", 2000)
    min_gpus = elastic.get("min_gpus", 1)
    max_gpus = elastic.get("max_gpus", 10000)
    prefer_larger = elastic.get("prefer_larger_batch", True)
    version = elastic.get("version", LATEST_ELASTICITY_VERSION)

    if float(version) >= 0.2:
        gpus_per_node = elastic.get("num_gpus_per_node", 1)
        final_batch, valid = get_compatible_gpus_v02(
            micro_batches, max_batch, world_size, min_gpus, max_gpus,
            prefer_larger, gpus_per_node)
    else:
        final_batch, valid = get_compatible_gpus_v01(
            micro_batches, max_batch, min_gpus, max_gpus)

    if world_size > 0:
        if world_size not in valid:
            raise ElasticityIncompatibleWorldSize(
                f"world size {world_size} not in valid sizes {valid[:20]}...")
        mb, gas = _get_microbatch_gas(final_batch, micro_batches, world_size,
                                      prefer_larger)
        logger.info(f"elastic config: global={final_batch} micro={mb} gas={gas} "
                    f"world={world_size}")
        if return_microbatch:
            return final_batch, valid, mb
        return final_batch, valid
    if return_microbatch:
        return final_batch, valid, None
    return final_batch, valid


def ensure_immutable_elastic_config(runtime_elastic_config_dict, ref_dict=None):
    """Reference ``:208``: the elasticity block must not change between
    resumes (it defines the invariant)."""
    if ref_dict is not None and runtime_elastic_config_dict != ref_dict:
        raise ElasticityConfigError(
            "elasticity config changed across restarts; the global batch "
            "invariant would break")
    return True
