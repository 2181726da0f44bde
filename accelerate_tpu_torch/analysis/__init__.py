"""Runtime analysis hooks (:mod:`.lockwatch`)."""
