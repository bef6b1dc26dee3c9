"""Scripts that take the readings behind the limits, on the chip."""
