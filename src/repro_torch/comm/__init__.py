"""Compressed-gossip communication: port of ``repro.comm`` — the
compressors (int8/int4 quantizers, top-k, random-k) and their round trips
and wire codecs (``compressors``), threefry keys, bits and uniform floats
bitwise ``jax.random``'s (``prng``), error feedback (``error_feedback``)
and the host-side byte ledger (``accounting``)."""
from repro_torch.comm.accounting import (BytesTracker, analytic_leaf_bytes,
                                         analytic_row_bytes,
                                         physical_leaf_bytes,
                                         tree_bucketed_wire_bytes_per_server,
                                         tree_physical_wire_bytes_per_server,
                                         uncompressed_row_bytes)
from repro_torch.comm.compressors import (Compressed, Compressor,
                                          IdentityCompressor,
                                          RandomKCompressor,
                                          StochasticQuantizer, TopKCompressor,
                                          bucket_block, keyed_index_sample,
                                          make_compressor, pack_int4,
                                          roundtrip_tree, tree_message_elems,
                                          tree_wire_bytes_per_server,
                                          unpack_int4, wire_dither)
from repro_torch.comm.error_feedback import ef_roundtrip, init_ef_residual

__all__ = [n for n in dir() if not n.startswith("_")]
