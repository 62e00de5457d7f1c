"""Serving: engine, continuous batchers (dense and paged), and the fleet router."""
