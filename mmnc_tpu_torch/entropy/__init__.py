"""Entropy models, CDF tables and the rANS bridge of the port."""
