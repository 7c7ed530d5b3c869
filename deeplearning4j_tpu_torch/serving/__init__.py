"""Serving: registry, dynamic-batching scheduler, HTTP front end."""
