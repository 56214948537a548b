"""``repro_torch.dist``: the flat-bucket layout, the int8 wire and the
bounded-loss wire format (``flatbuf``), the MLfabric gradient reduction over
a mesh with its host, switch and hierarchical backends and its sparse
cross-pod stage (``collectives``), the phase-aware loss policy (``policy``),
the batch axes (``sharding``) and elastic sessions that rebuild on device
loss and restore from the bounded-divergence replica (``elastic``)."""

from . import collectives, elastic, flatbuf, policy, sharding
from .collectives import (loss_drop_mask, mlfabric_grad_reduce, plan_reduce,
                          reduce_flat_buckets, unpack_reduced)
from .flatbuf import (Bucket, ErrorFeedback, FlatLayout, SparseChunk,
                      bucket_slice, flat_compress_roundtrip, pack_leaves,
                      plan_buckets, plan_flat_layout, sparse_quantize,
                      topk_sparsify, unpack_bucket)
from .elastic import ElasticSession, Grid, surviving_mesh
from .policy import PhaseLossCallback, PhaseLossPolicy
from .sharding import data_axes

__all__ = ["collectives", "elastic", "flatbuf", "policy", "sharding",
           "loss_drop_mask", "mlfabric_grad_reduce", "plan_reduce",
           "reduce_flat_buckets", "unpack_reduced",
           "Bucket", "ErrorFeedback", "FlatLayout", "SparseChunk",
           "bucket_slice", "flat_compress_roundtrip", "pack_leaves",
           "plan_buckets", "plan_flat_layout", "sparse_quantize",
           "topk_sparsify", "unpack_bucket",
           "ElasticSession", "Grid", "surviving_mesh",
           "PhaseLossCallback", "PhaseLossPolicy", "data_axes"]
