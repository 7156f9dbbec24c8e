"""The runners a traffic file's ``kind`` names: ``train`` drives the
program's training step, ``gate`` the readiness gate's pod entry."""
