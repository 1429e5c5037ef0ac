"""Launchers: the serving command line."""
