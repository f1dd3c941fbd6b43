"""Graph generators and update streams (mirrors ``repro.graph``)."""
