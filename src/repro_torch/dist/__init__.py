from .flatbuf import (Bucket, FlatLayout, flat_compress_roundtrip,
                      pack_leaves, plan_buckets, plan_flat_layout)

__all__ = ["Bucket", "FlatLayout", "flat_compress_roundtrip", "pack_leaves",
           "plan_buckets", "plan_flat_layout"]
