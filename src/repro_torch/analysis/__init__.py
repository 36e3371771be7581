"""Closed-form traffic models (the port's copy of what it reads)."""
