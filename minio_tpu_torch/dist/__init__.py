"""Node bootstrap of the port: one node over local drives (node.py).

The JAX package's distribution layer (storage, lock and peer REST, dsync
locks, transport) is not ported yet (ROADMAP.md, Queue A item 7).
"""
