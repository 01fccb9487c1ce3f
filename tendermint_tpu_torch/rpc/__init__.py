"""The RPC surface's JSON encoders (``json_enc``), which the light-serving
plane renders its header documents with. The JSON-RPC server, its routes
and its clients are not ported yet; this package imports nothing else."""
