"""The capability tier the reference ships as x-pack plugins.

Each module re-designs one x-pack subsystem for this build's
architecture: security (realm + RBAC at the REST boundary), async
search, SQL, transforms, watcher. They are ordinary packages — no
plugin classloader — but they only touch public seams (cluster-state
metadata, master actions, the REST controller, NodeClient), the same
discipline the reference enforces through its SPI.
"""
