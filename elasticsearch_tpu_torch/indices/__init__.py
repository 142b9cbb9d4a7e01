"""Node-level index services. Only the circuit breakers are carried so far
(``indices.breaker``); the index/cluster-state services come with the node
layer."""
