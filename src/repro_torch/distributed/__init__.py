"""Logical-axis sharding rules and the collectives of explicit SPMD."""
