"""Runners of the traffic kinds: ``kinds/<kind>.py`` runs the mixes of that kind."""
