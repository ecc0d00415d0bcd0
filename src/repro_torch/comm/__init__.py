"""Wire accounting and the collectives between machines of the port
(counterpart of ``repro.comm``): :mod:`.accounting` (the ledgers),
:mod:`.collectives` (the exact ops, the one caller of
``torch.distributed``) and :mod:`.quantized_collectives` (the paper's wire
as collectives: ``q_all_gather``, ``q_psum``)."""
from .quantized_collectives import q_all_gather, q_psum, wire_bits_all_gather  # noqa: F401

__all__ = ["q_all_gather", "q_psum", "wire_bits_all_gather"]
