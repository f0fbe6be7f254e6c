"""Streaming runtime of the port: multi-stream ingest into batched detection."""
