"""Offline merge of a training checkpoint into one fp32 state dict (port
of ``deepspeed_tpu/utils/zero_to_fp32.py``; reference
``deepspeed/utils/zero_to_fp32.py``): runs on the CPU without building
the model.  At world size 1 a tag holds whole tensors, so the merge is a
host read and an fp32 cast.  The keys are the flax paths the JAX tool
writes (``params/embed_tokens/embedding``, ``params/layers/attn/...``),
converted by ``params_to_flax`` with the model config the tag's metadata
records (``model_config``); a tag of a module without one keeps its
``state_dict`` names.

Usage:  python -m deepspeed_tpu_torch.utils.zero_to_fp32 <ckpt_dir> <output_file>
"""

import argparse

import torch

from deepspeed_tpu_torch.utils.logging import logger


def get_fp32_state_dict_from_zero_checkpoint(checkpoint_dir, tag=None):
    """``{key: float32 tensor}`` for every module parameter of the tag
    (``latest``'s when ``tag`` is None)."""
    from deepspeed_tpu_torch.checkpoint.deepspeed_checkpoint import (
        DeepSpeedCheckpoint)
    from deepspeed_tpu_torch.models.transformer import (TransformerConfig,
                                                        params_to_flax)
    ckpt = DeepSpeedCheckpoint(checkpoint_dir, tag=tag)
    sd = ckpt.flat_parameters()
    cfg = ckpt.meta.get("model_config")
    if cfg is not None:
        sd = {f"params/{k}": v for k, v in
              params_to_flax(sd, TransformerConfig(**cfg)).items()}
    return {k: v.float() if v.is_floating_point() else v
            for k, v in sd.items()}


def convert_zero_checkpoint_to_fp32_state_dict(checkpoint_dir, output_file,
                                               tag=None):
    state_dict = get_fp32_state_dict_from_zero_checkpoint(checkpoint_dir, tag)
    torch.save(state_dict, output_file)
    logger.info(f"saved fp32 state dict ({len(state_dict)} tensors) to "
                f"{output_file}")
    return output_file


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Merge a deepspeed_tpu_torch checkpoint to one fp32 "
                    "state dict")
    parser.add_argument("checkpoint_dir")
    parser.add_argument("output_file")
    parser.add_argument("-t", "--tag", default=None)
    args = parser.parse_args(argv)
    convert_zero_checkpoint_to_fp32_state_dict(args.checkpoint_dir,
                                               args.output_file, tag=args.tag)


if __name__ == "__main__":
    main()
