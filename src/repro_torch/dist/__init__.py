"""``repro_torch.dist``: the flat-bucket layout, the int8 wire and the
bounded-loss wire format (``flatbuf``), the MLfabric gradient reduction over
a mesh with its host, switch and hierarchical backends and its sparse
cross-pod stage (``collectives``), the phase-aware loss policy and the
activation-layout policy the model code queries (``policy``:
``sharding_policy``, ``constrain``), the partition rules of params, inputs,
caches and activations over a ``model`` axis (``sharding``) and elastic
sessions that rebuild on device loss and restore from the bounded-divergence
replica (``elastic``)."""

from . import collectives, elastic, flatbuf, policy, sharding
from .collectives import (loss_drop_mask, mlfabric_grad_reduce, plan_reduce,
                          reduce_flat_buckets, unpack_reduced)
from .flatbuf import (Bucket, ErrorFeedback, FlatLayout, SparseChunk,
                      bucket_slice, flat_compress_roundtrip, pack_leaves,
                      plan_buckets, plan_flat_layout, sparse_quantize,
                      topk_sparsify, unpack_bucket)
from .elastic import ElasticSession, Grid, surviving_mesh
from .policy import (PartitionSpec, PhaseLossCallback, PhaseLossPolicy,
                     constrain, current_policy, sharding_policy)
from .sharding import (activation_policy, batch_shardings, batch_spec_axes,
                       cache_shardings, data_axes, head_policy,
                       param_shardings, placements)

__all__ = ["collectives", "elastic", "flatbuf", "policy", "sharding",
           "loss_drop_mask", "mlfabric_grad_reduce", "plan_reduce",
           "reduce_flat_buckets", "unpack_reduced",
           "Bucket", "ErrorFeedback", "FlatLayout", "SparseChunk",
           "bucket_slice", "flat_compress_roundtrip", "pack_leaves",
           "plan_buckets", "plan_flat_layout", "sparse_quantize",
           "topk_sparsify", "unpack_bucket",
           "ElasticSession", "Grid", "surviving_mesh",
           "PartitionSpec", "PhaseLossCallback", "PhaseLossPolicy",
           "constrain", "current_policy", "sharding_policy",
           "activation_policy", "batch_shardings", "batch_spec_axes",
           "cache_shardings", "data_axes", "head_policy", "param_shardings",
           "placements"]
