"""The benchmark's modes, one module each, found by a cell's ``mode``."""
