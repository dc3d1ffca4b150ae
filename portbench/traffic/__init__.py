"""Traffic kinds, one module each, found by the kind's name."""
