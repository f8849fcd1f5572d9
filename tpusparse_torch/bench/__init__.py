"""The headline solve driver."""
