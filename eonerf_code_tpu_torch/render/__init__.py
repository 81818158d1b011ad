"""Renderers: satellite camera rays and the nadir virtual camera."""
