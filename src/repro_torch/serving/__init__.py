"""The serving engine of the port: replicas as locality domains."""
