"""Scripts that measure the port on the card; none is imported by it."""
