"""Version constants.

Mirrors the role of the reference's buildSrc/version.properties:1 and
``org.elasticsearch.Version`` (server/src/main/java/org/elasticsearch/Version.java):
a single integer wire id used in transport handshakes plus a human string.
"""

__version__ = "0.1.0"

# Wire-format version id, bumped on any incompatible serialization change.
# Reference analog: Version.CURRENT.id used in the TCP header
# (server/.../transport/TcpHeader.java:31-49).
WIRE_VERSION = 1_000_099

# Lowest wire version we can still talk to (rolling-upgrade support).
MIN_COMPATIBLE_WIRE_VERSION = 1_000_099
