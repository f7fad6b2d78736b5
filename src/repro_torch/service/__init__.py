"""The port's DSE service over the batched exploration engine.

Turns ``ExplorationEngine`` into an always-on exploration service, as the
reference's ``repro.service`` does:

* ``queue.py``   -- thread-backed job queue: priorities, micro-batching
  (submissions coalesce for a small window / size threshold), canonical-key
  dedup, one engine ``run()`` per batch bucket, and continuous batching
  (late portfolio jobs join a running bandit race at its next wave);
* ``streams.py`` -- ``submit() -> ExploreFuture``, ``as_completed()``,
  ``stream_pareto()``: callers receive each job's result the moment its
  bucket finishes, not when the whole submission drains;
* ``store.py``   -- persistent on-disk result store (content-addressed by
  job key, JSONL records, atomic rename) in a ``repro_torch/``
  subdirectory of the reference's store root;
* ``client.py``  -- programmatic client + process-wide
  :func:`default_service` (one per device and dtype), which
  ``co_explore`` / ``co_explore_macros`` / ``pareto_explore`` use as
  their synchronous front door; ``ServiceClient(base_url=...)`` (or
  ``CIM_TUNER_SERVICE_URL``) switches to remote mode against a running
  port HTTP front door, and refuses anything else at that URL;
* ``server.py``  -- ``python -m repro_torch.service serve``: stdlib HTTP
  front door (job POSTs, SSE streaming, shared-store GETs, /healthz +
  /v1/stats) so many OS processes and hosts share ONE engine and result
  store;
* ``python -m repro_torch.service`` -- CLI: ``explore``, ``serve``,
  ``stats``, ``store``, ``trace``, ``timeline``, and the kernel tier's
  ``profile`` and ``calibrate``.

Every entry point runs on the CUDA card unless the caller asks for
``device="cpu"`` (``--device cpu``).

Quickstart::

    from repro_torch.service import as_completed, default_service
    svc = default_service()                       # the card
    futures = svc.submit_many(jobs, method="exhaustive")
    for fut in as_completed(futures):
        print(fut.result().summary())
"""
from repro_torch.service.client import (RemoteQueue, ServiceClient,
                                        default_service, job_from_spec,
                                        job_to_spec, merge_spec_settings,
                                        reset_default_service,
                                        settings_from_spec, settings_to_spec)
from repro_torch.service.queue import JobQueue, QueueConfig, values_key
from repro_torch.service.store import (RemoteStoreTier, ResultStore,
                                       default_store, deserialize_result,
                                       serialize_result)
from repro_torch.service.streams import (ExploreFuture, as_completed,
                                         stream_pareto, stream_results)

__all__ = [
    "ServiceClient", "RemoteQueue", "default_service",
    "reset_default_service",
    "job_from_spec", "job_to_spec", "settings_from_spec",
    "settings_to_spec", "merge_spec_settings",
    "JobQueue", "QueueConfig", "values_key",
    "ResultStore", "RemoteStoreTier", "default_store", "serialize_result",
    "deserialize_result",
    "ExploreFuture", "as_completed", "stream_results", "stream_pareto",
]
