"""Distribution layer of the port: node bootstrap (node.py), the internode
transport (transport.py), storage REST with remote drives (storage_rest.py),
dsync locks (locks.py) and the peer control plane (peer.py), each a copy of
the JAX package's module speaking the same wire.
"""
