"""Point-cloud density filtering."""
