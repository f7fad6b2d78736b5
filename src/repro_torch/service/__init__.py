"""``python -m repro_torch.service`` -- the port's command line.

So far it has the reference's kernel subcommands: ``profile`` (the
kernel micro-profile pass) and ``calibrate`` (measure -> fit -> write a
calibration artifact).  The reference's job queue, streams, result store,
client and HTTP server (``explore``, ``serve``, ...) are not ported yet.
"""
