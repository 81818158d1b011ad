"""Device-side DSM evaluation."""
