"""Passive tracer particles (the reference's Tracker, src/Particles)."""

from .tracker import ParticleTracker, seed_particles

__all__ = ["ParticleTracker", "seed_particles"]
