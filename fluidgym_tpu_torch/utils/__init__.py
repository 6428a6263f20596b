"""Framework utilities: initial-domain data access, field output, logging
and seeding."""
