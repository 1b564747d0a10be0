"""MX formats, transfer schedules, sampling and blocked diffusion."""
