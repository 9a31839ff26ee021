"""Alignment drivers and the batched executor they run on."""
