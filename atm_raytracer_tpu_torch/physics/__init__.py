"""Refraction physics: atmosphere model and the ray march."""
