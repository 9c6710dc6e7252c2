"""Config keys and defaults (port of ``deepspeed_tpu/runtime/constants.py``).

Only the keys the training slice's config and optimizer factory read; the
names match the JAX package (and DeepSpeed's JSON schema).
"""

# Batch size triple
TRAIN_BATCH_SIZE = "train_batch_size"
TRAIN_MICRO_BATCH_SIZE_PER_GPU = "train_micro_batch_size_per_gpu"
GRADIENT_ACCUMULATION_STEPS = "gradient_accumulation_steps"

# Optimizer / scheduler
OPTIMIZER = "optimizer"
SCHEDULER = "scheduler"

ADAM_OPTIMIZER = "adam"
ADAMW_OPTIMIZER = "adamw"
FUSED_ADAM_OPTIMIZER = "fusedadam"
CPU_ADAM_OPTIMIZER = "cpuadam"
LAMB_OPTIMIZER = "lamb"
ONEBIT_ADAM_OPTIMIZER = "onebitadam"
ZERO_ONE_ADAM_OPTIMIZER = "zerooneadam"
ONEBIT_LAMB_OPTIMIZER = "onebitlamb"
SGD_OPTIMIZER = "sgd"
ADAGRAD_OPTIMIZER = "adagrad"
LION_OPTIMIZER = "lion"

# Precision
FP16 = "fp16"
BF16 = "bf16"

# Gradients
GRADIENT_CLIPPING = "gradient_clipping"
GRADIENT_CLIPPING_DEFAULT = 0.0

# ZeRO
ZERO_OPTIMIZATION = "zero_optimization"

# Logging
STEPS_PER_PRINT = "steps_per_print"
COMMS_LOGGER = "comms_logger"
STEPS_PER_PRINT_DEFAULT = 10
WALL_CLOCK_BREAKDOWN = "wall_clock_breakdown"

# Subsystems whose enabling is refused by this slice
FLOPS_PROFILER = "flops_profiler"
MONITOR_TENSORBOARD = "tensorboard"
MONITOR_WANDB = "wandb"
MONITOR_CSV = "csv_monitor"
COMPRESSION_TRAINING = "compression_training"
CURRICULUM_LEARNING_LEGACY = "curriculum_learning"

# Parallelism
TENSOR_PARALLEL = "tensor_parallel"
PIPELINE_PARALLEL = "pipeline"
SEQUENCE_PARALLEL = "sequence_parallel"
