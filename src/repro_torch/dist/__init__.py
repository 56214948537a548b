"""``repro_torch.dist``: the flat-bucket layout, the int8 wire and the
bounded-loss wire format (``flatbuf``), the MLfabric gradient reduction over
a mesh with its host, switch and hierarchical backends and its sparse
cross-pod stage (``collectives``), the phase-aware loss policy (``policy``)
and the batch axes (``sharding``)."""

from . import collectives, flatbuf, policy, sharding
from .collectives import (loss_drop_mask, mlfabric_grad_reduce, plan_reduce,
                          reduce_flat_buckets, unpack_reduced)
from .flatbuf import (Bucket, ErrorFeedback, FlatLayout, SparseChunk,
                      bucket_slice, flat_compress_roundtrip, pack_leaves,
                      plan_buckets, plan_flat_layout, sparse_quantize,
                      topk_sparsify, unpack_bucket)
from .policy import PhaseLossCallback, PhaseLossPolicy
from .sharding import data_axes

__all__ = ["collectives", "flatbuf", "policy", "sharding",
           "loss_drop_mask", "mlfabric_grad_reduce", "plan_reduce",
           "reduce_flat_buckets", "unpack_reduced",
           "Bucket", "ErrorFeedback", "FlatLayout", "SparseChunk",
           "bucket_slice", "flat_compress_roundtrip", "pack_leaves",
           "plan_buckets", "plan_flat_layout", "sparse_quantize",
           "topk_sparsify", "unpack_bucket",
           "PhaseLossCallback", "PhaseLossPolicy", "data_axes"]
