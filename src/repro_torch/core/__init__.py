"""Helix attention on one card (emulated KVP), the LSE combine, and the KV
cache layouts (fixed round-robin rows or a paged pool)."""
