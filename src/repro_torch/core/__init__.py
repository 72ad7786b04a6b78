"""The Sparton head: the plain ladder and the unified head API."""
