"""Serving primitives; so far the micro-batching the evaluator shares."""
