"""The satellite ray tensor."""
