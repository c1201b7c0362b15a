"""Seeded input generators and the traffic mixes they read."""
