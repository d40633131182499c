"""Frozen copies of the program's plain geometry and tracker."""
