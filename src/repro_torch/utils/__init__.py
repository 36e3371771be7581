"""Host-side helpers of the port (numpy data generators)."""
