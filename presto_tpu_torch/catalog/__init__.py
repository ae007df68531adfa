"""Connectors of the port: in-memory tables and the TPC-H generator."""
