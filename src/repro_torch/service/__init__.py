"""Batched ordering service, the port of the reference's ``repro.service``.

High-throughput front end over the port's nested dissection: a request
queue with a graph fingerprint cache, the unified wave router — ONE
shared lane stack across all concurrently-submitted orderings — and
bucketed execution of every wave's subproblems that share a padded ELL
shape, on the card unless the caller names the CPU.  Host graphs
(``submit``) and distributed ``DGraph`` requests (``submit_distributed``)
share the router.
"""
from repro_torch.service.api import OrderingService, OrderResult
from repro_torch.service.cache import FingerprintCache
from repro_torch.service.fingerprint import (dgraph_fingerprint,
                                             graph_fingerprint,
                                             request_fingerprint)
from repro_torch.service.router import RouterConfig, WaveRouter, \
    execute_wave
from repro_torch.service.scheduler import order_batch

__all__ = ["OrderingService", "OrderResult", "FingerprintCache",
           "RouterConfig", "WaveRouter", "dgraph_fingerprint",
           "execute_wave", "graph_fingerprint", "order_batch",
           "request_fingerprint"]
