"""Reference motions for the tracking tasks (`reference_motion`)."""
