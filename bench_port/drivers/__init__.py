"""The general traffic generators, one module per traffic ``kind``."""
