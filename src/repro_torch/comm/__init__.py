"""Compressed-gossip communication: port of ``repro.comm`` for the physical
wire — the int8/int4 quantizers as wire codecs (``compressors``), the
threefry keys of the wire dither (``prng``), error feedback's residual
(``error_feedback``) and the host-side byte ledger (``accounting``)."""
from repro_torch.comm.accounting import (BytesTracker, analytic_leaf_bytes,
                                         analytic_row_bytes,
                                         physical_leaf_bytes,
                                         tree_bucketed_wire_bytes_per_server,
                                         tree_physical_wire_bytes_per_server,
                                         uncompressed_row_bytes)
from repro_torch.comm.compressors import (Compressed, Compressor,
                                          IdentityCompressor,
                                          StochasticQuantizer, bucket_block,
                                          make_compressor, pack_int4,
                                          tree_message_elems, unpack_int4,
                                          wire_dither)
from repro_torch.comm.error_feedback import init_ef_residual

__all__ = [n for n in dir() if not n.startswith("_")]
