"""Batched greedy serving over the language model's cache-carrying path."""
