"""The distributed control plane's pieces the port has so far:
``retry`` (the backoff policy the serving supervisor paces respawns
with).  The rest of ``paddle_tpu/distributed/`` waits for its slice."""
