"""``repro_torch.dist``: the flat-bucket layout and the int8 wire
(``flatbuf``), the MLfabric gradient reduction over a mesh
(``collectives``) and the batch axes (``sharding``)."""

from . import collectives, flatbuf, sharding
from .collectives import (loss_drop_mask, mlfabric_grad_reduce, plan_reduce,
                          reduce_flat_buckets, unpack_reduced)
from .flatbuf import (Bucket, FlatLayout, bucket_slice,
                      flat_compress_roundtrip, pack_leaves, plan_buckets,
                      plan_flat_layout, unpack_bucket)
from .sharding import data_axes

__all__ = ["collectives", "flatbuf", "sharding",
           "loss_drop_mask", "mlfabric_grad_reduce", "plan_reduce",
           "reduce_flat_buckets", "unpack_reduced",
           "Bucket", "FlatLayout", "bucket_slice", "flat_compress_roundtrip",
           "pack_leaves", "plan_buckets", "plan_flat_layout",
           "unpack_bucket", "data_axes"]
