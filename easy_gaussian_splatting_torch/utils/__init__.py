"""Shared utilities: logging and checkpoint IO."""
