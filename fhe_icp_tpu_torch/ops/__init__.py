"""Crypto core of the port: tables, modmath, NTT, BGV, packing, scoring."""
