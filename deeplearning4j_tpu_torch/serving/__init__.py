"""Serving: registry, dynamic-batching scheduler, continuous batcher,
HTTP front end."""
