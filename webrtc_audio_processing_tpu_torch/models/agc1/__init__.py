"""AGC1: the legacy gain controller and the hybrid AgcManagerDirect."""
