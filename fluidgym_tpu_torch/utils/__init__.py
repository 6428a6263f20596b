"""Framework utilities: initial-domain data access."""
