"""`ae_card_ms.<suffix>`: the card ms a unit of the profiled segment's
`ae.encode` and `ae.decode` spans, from the card event at a span's open to
the one at its close: the autoencoders' time a slice of the batch."""

from perfbench.ae_readers import ae_card_ms as read  # noqa: F401
