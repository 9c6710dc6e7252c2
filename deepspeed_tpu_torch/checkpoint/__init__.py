"""Offline checkpoint tools (port of ``deepspeed_tpu/checkpoint/``): the
:class:`DeepSpeedCheckpoint` / :class:`ZeROCheckpoint` readers over the
port's tags, the universal (topology-free) conversion and load, TP shard
surgery, and the safetensors format."""

from deepspeed_tpu_torch.checkpoint.deepspeed_checkpoint import (  # noqa: F401
    DeepSpeedCheckpoint, ZeROCheckpoint)
from deepspeed_tpu_torch.checkpoint.universal_checkpoint import (  # noqa: F401
    convert_to_universal, load_hp_checkpoint_state, load_universal_meta,
    load_universal_into_engine)
from deepspeed_tpu_torch.checkpoint.reshape_utils import (  # noqa: F401
    merge_tp_shards, split_tp_shards, reshape_tp, reshape_flat_state_dict,
    infer_tp_dim, partition_data)
