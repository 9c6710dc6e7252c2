from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import (
    SparsityConfig, DenseSparsityConfig, FixedSparsityConfig,
    VariableSparsityConfig, BigBirdSparsityConfig, BSLongformerSparsityConfig,
    LocalSlidingWindowSparsityConfig)
from deepspeed_tpu_torch.ops.sparse_attention.block_sparse import (
    block_sparse_attention, sparse_attention_reference, layout_tables)
from deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention import (
    SparseSelfAttention, SparseAttentionFn)
