"""Paged KV cache, attention planner and continuous-batching engine."""
