"""Slotted packet simulator: host tables, tick phases and run loop."""
