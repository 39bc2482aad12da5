"""Connectors: the SPI and the memory connector."""
