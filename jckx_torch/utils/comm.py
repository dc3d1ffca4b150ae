"""Cross-shard collective inventory — the counterpart of
``jckx/utils/hlo.py``'s ``comm_inventory`` (``:43-71``).

jckx reads its collectives out of the optimized HLO module that GSPMD
wrote. The port has no HLO: PyTorch runs eagerly and the mesh names each
collective itself (``parallel/mesh.py``), counting every call in
``ProcessMesh.stats`` by kind and by the dtype that went over the wire.
``comm_inventory`` turns those counts into jckx's report: the mesh's kinds
under jckx's HLO op names (a halo exchange is a ``collective-permute``)
and the dtypes in HLO's spelling (``f32``, ``bf16``, ...). Bytes are per
rank, as jckx's are per chip.
"""

from __future__ import annotations

import torch

# the mesh's kinds → jckx's HLO op names
HLO_OPS = {"all_reduce": "all-reduce", "all_gather": "all-gather",
           "reduce_scatter": "reduce-scatter", "halo_send_recv": "collective-permute"}

# torch dtypes → HLO's element-type names (jckx/utils/hlo.py:_DTYPE_BYTES)
HLO_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16",
              torch.float64: "f64", torch.int32: "s32", torch.int64: "s64", torch.int8: "s8",
              torch.uint8: "u8", torch.bool: "pred"}


def comm_inventory(stats) -> dict:
    """op → {count, bytes_total, by_dtype: {dtype: {count, bytes}}} over a
    ``CollectiveStats``; kinds with no calls are left out, as in jckx."""
    comm: dict = {}
    for kind, op in HLO_OPS.items():
        if not stats.calls[kind]:
            continue
        comm[op] = {"count": stats.calls[kind], "bytes_total": stats.bytes[kind],
                    "by_dtype": {HLO_DTYPES.get(dt, str(dt).removeprefix("torch.")):
                                 {"count": calls, "bytes": nbytes}
                                 for dt, (calls, nbytes) in stats.by_dtype[kind].items()}}
    return comm
