"""The serving engine: paged KV over PGAS, chunked prefill, SLOs."""
