"""The yardstick's arithmetic: the work a kernel's shape needs and the card's peaks."""
